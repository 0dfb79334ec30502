"""A real tokenizer for the examples, built fully offline (a copy of the
JAX package's ``examples/demo_tokenizer.py``).

The environment has no network access to huggingface.co, so instead of
downloading a pretrained vocab this trains a genuine byte-level BPE
tokenizer (HF ``tokenizers``, the same Rust core every HF fast
tokenizer uses) on a small embedded corpus at first use — text encodes
to subword ids and decodes back losslessly, exactly like a production
tokenizer. When the ``tokenizers`` package is unavailable it degrades
to the old word-hash stand-in (encode-only).

    tok = get_tokenizer(vocab_size=512)
    ids = tok.encode("the quick brown fox")
    text = tok.decode(ids)          # round trips for kind == "bpe"
"""

_CORPUS = """
the quick brown fox jumps over the lazy dog
a journey of a thousand miles begins with a single step
to be or not to be that is the question
ask not what your country can do for you
all that glitters is not gold and all who wander are not lost
the cache holds the keys and values of every token seen so far
reuse the prefix compute only the suffix and the first token is fast
pages hold the cache chunks hash the tokens servers share the store
"""


class _HashTokenizer:
    kind = "hash"

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str):
        import hashlib
        out = []
        for word in text.split():
            h = hashlib.sha256(word.encode()).digest()
            out.append(int.from_bytes(h[:2], "little") % self.vocab_size)
        return out

    def decode(self, ids):
        return " ".join(map(str, ids))  # hashes don't invert


class _BPETokenizer:
    kind = "bpe"

    def __init__(self, vocab_size: int):
        from tokenizers import (Tokenizer, decoders, models,
                                pre_tokenizers, trainers)
        self.vocab_size = vocab_size
        tok = Tokenizer(models.BPE(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(
            add_prefix_space=True)
        tok.decoder = decoders.ByteLevel()
        trainer = trainers.BpeTrainer(
            vocab_size=vocab_size, special_tokens=["<unk>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            show_progress=False)
        tok.train_from_iterator(_CORPUS.strip().splitlines(), trainer)
        self._tok = tok

    def encode(self, text: str):
        return self._tok.encode(text).ids

    def decode(self, ids):
        return self._tok.decode(list(map(int, ids)))


def get_tokenizer(vocab_size: int = 512):
    """Best available tokenizer whose ids stay < ``vocab_size``."""
    try:
        return _BPETokenizer(vocab_size)
    except Exception:  # tokenizers missing — degrade loudly
        print("[demo_tokenizer] HF `tokenizers` unavailable; "
              "falling back to the word-hash stand-in")
        return _HashTokenizer(vocab_size)
