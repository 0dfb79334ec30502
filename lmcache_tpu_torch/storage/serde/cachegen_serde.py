"""CacheGen codec serde: quantization, range coding, a fixed binary container.

Port of ``lmcache_tpu/storage/serde/cachegen_serde.py``; the containers are
byte-identical with the JAX serializer's, so either package reads what the
other wrote.

- quantization, CDF estimation and dequantization are torch ops on the
  blob's device (:mod:`lmcache_tpu_torch.ops.quant`);
- range coding runs where ``cachegen_device_encode`` / ``_decode`` say:
  ``"auto"`` (and its alias ``"on"``) runs the Hopper kernels (rows 12 and
  11) for tensors on the card and their plain versions for CPU tensors,
  ``"off"``
  the host C++ coder (:mod:`lmcache_tpu_torch.codec.range_coder`). No path
  falls back to another;
- one stream per (half, layer, channel group), as in the JAX package.

Container layout (version 2; version 3 adds the stream count N, 1 for an
MLA latent blob, after ``group``):

    magic    4s  b"LMCG"      version u16      fmt u8 (0 vllm, 1 hf)
    dlen u8                   dtype ascii[dlen]
    L u16    H u16  D u16     T u32
    key_bins  u8[L]           value_bins u8[L]
    group    u8                       (channels per shared CDF; v1: 1)
    maxes    f32[N, L, T]
    cdf      u16[N, L, C/g, 33]       (C = H*D, g = group)
    lens     u32[N, L, C/g]
    payload  key streams then value streams, concatenated

Short chunks pool ``g`` adjacent channels into one CDF and one g*T-symbol
stream (``_group_for``), so the fixed tables shrink with the payload.
"""

import struct
from typing import List, Optional, Sequence

import numpy as np
import torch

from lmcache_tpu_torch.codec import range_coder
from lmcache_tpu_torch.codec.cachegen_config import _MAX_BINS, CacheGenConfig
from lmcache_tpu_torch.config import (CODER_MODES, LMCacheEngineConfig,
                                      LMCacheEngineMetadata)
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.ops import quant, range_decode, range_encode
from lmcache_tpu_torch.storage.serde.raw_serde import dtype_name, torch_dtype
from lmcache_tpu_torch.storage.serde.serde import Deserializer, Serializer
from lmcache_tpu_torch.utils import _lmcache_trace_annotate, resolve_device

logger = init_logger(__name__)

MAGIC = b"LMCG"
VERSION = 2
_HDR = struct.Struct("<4sHBB")
_GEOM = struct.Struct("<HHHI")
_FMT_CODE = {"vllm": 0, "huggingface": 1}
_FMT_NAME = {v: k for k, v in _FMT_CODE.items()}


def _group_for(T: int, C: int, min_g: int = 1) -> int:
    """Channels per shared CDF, adaptive on chunk length: full chunks
    keep per-channel CDFs (best ratio), short chunks pool channels so
    the fixed header scales down with the payload. ``min_g`` forces a
    floor: latent streams use 4 because their channels share one
    RMS-normalized distribution."""
    g = 1
    while T * g < 256 and g < 16 and C % (g * 2) == 0:
        g *= 2
    while g < min_g and C % (g * 2) == 0:
        g *= 2
    return g


class CacheGenSerializer(Serializer):

    def __init__(self, config: LMCacheEngineConfig,
                 metadata: LMCacheEngineMetadata,
                 cachegen_config: Optional[CacheGenConfig] = None):
        """``cachegen_config`` overrides the model-name-derived bin
        schedule (the containers are self-describing, so the deserializer
        needs no matching override)."""
        self.fmt = metadata.fmt
        self.model_name = metadata.model_name
        self._cg_override = cachegen_config
        self._cg_cache = {}
        self.encode_mode = config.cachegen_device_encode

    def _encode_streams(self, streams: torch.Tensor, cdf: torch.Tensor):
        """Entropy-encode uint8 [S, T'] streams against their CDFs (int16
        bits [S, 33]) -> (payload uint8 array, lens int64, cdf uint16 host
        array). ``"off"`` downloads the symbols for the host coder; else
        the streams are coded where they lie and only the coded bytes and
        the lengths cross to the host."""
        cdf_h = quant.cdf_to_numpy(cdf)
        if self.encode_mode == "off":
            payload, lens = range_coder.encode_streams(streams.cpu().numpy(),
                                                       cdf_h)
            return np.frombuffer(payload, np.uint8), lens, cdf_h
        payload, lens = range_encode.encode_streams(streams, cdf)
        return payload, lens, cdf_h

    def _cg(self, num_layers: int) -> CacheGenConfig:
        if (self._cg_override is not None
                and self._cg_override.num_layers == num_layers):
            return self._cg_override
        if num_layers not in self._cg_cache:
            self._cg_cache[num_layers] = CacheGenConfig.from_model_name(
                self.model_name, num_layers)
        return self._cg_cache[num_layers]

    def _geometry(self, blob_shape):
        """(L, N, T, H, D, C, g, Cg, cg) for a blob of this shape. N is 2
        for K/V blobs and 1 for MLA latent blobs ([L, 1, T, 1, r+p])."""
        if self.fmt == "huggingface":
            L, N, H, T, D = blob_shape
        else:
            L, N, T, H, D = blob_shape
        if N not in (1, 2):
            raise ValueError(f"blob axis 1 must be 1 (latent) or 2 (K/V), "
                             f"got {N}")
        C = H * D
        g = _group_for(T, C, min_g=4 if N == 1 else 1)
        if N == 1 and self._cg_override is None:
            cg = CacheGenConfig.for_latent(L)
        else:
            cg = self._cg(L)
        return L, N, T, H, D, C, g, C // g, cg

    def _container(self, L, N, T, H, D, g, cg, dtype_bytes,
                   halves) -> bytes:
        """Assemble one LMCG container from its computed pieces: ``halves``
        holds, for each of the N halves, its maxes (float32 [L, T]), CDF
        tables (uint16 [L, Cg, 33]), lengths (uint32 [L * Cg]) and payload,
        each contiguous, so that the join copies each byte once."""
        version = VERSION if N == 2 else 3  # v3 adds the stream count
        parts = [
            _HDR.pack(MAGIC, version, _FMT_CODE[self.fmt],
                      len(dtype_bytes)),
            dtype_bytes,
            _GEOM.pack(L, H, D, T),
            np.asarray(cg.key_bins, np.uint8).tobytes(),
            np.asarray(cg.value_bins, np.uint8).tobytes(),
            struct.pack("<B", g),
        ]
        if version >= 3:
            parts.append(struct.pack("<B", N))
        for i in range(4):  # maxes, CDF tables, lengths, payloads
            parts.extend(memoryview(h[i]) for h in halves)
        return b"".join(parts)

    def _bins(self, cg: CacheGenConfig, N: int, device):
        key = torch.tensor(cg.key_bins, dtype=torch.int32, device=device)
        value = torch.tensor(cg.value_bins, dtype=torch.int32,
                             device=device)
        return (key, value) if N == 2 else (key,)

    @_lmcache_trace_annotate
    def to_bytes(self, blob) -> bytes:
        return self._encode_stacked(torch.as_tensor(blob)[None])[0]

    @_lmcache_trace_annotate
    def to_bytes_batch(self, blobs) -> List[bytes]:
        """Encode many chunks with one quantization, one CDF pass and one
        coder launch per half for every group of same-shape chunks (all but
        a trailing short chunk, in a store). Byte-identical to per-chunk
        ``to_bytes``."""
        blobs = [torch.as_tensor(b) for b in blobs]
        out: List[Optional[bytes]] = [None] * len(blobs)
        groups: dict = {}
        for i, b in enumerate(blobs):
            groups.setdefault((tuple(b.shape), b.dtype, b.device),
                              []).append(i)
        for idxs in groups.values():
            if len(idxs) == 1:
                out[idxs[0]] = self.to_bytes(blobs[idxs[0]])
                continue
            stacked = torch.stack([blobs[i] for i in idxs])
            for i, bs in zip(idxs, self._encode_stacked(stacked)):
                out[i] = bs
        return out  # type: ignore[return-value]

    def _encode_stacked(self, stacked: torch.Tensor) -> List[bytes]:
        """Containers of n same-shape chunks ``stacked`` [n, *blob shape]:
        one quantization and one CDF pass a half, one coder pass over every
        stream of both halves."""
        n = stacked.shape[0]
        L, N, T, H, D, C, g, Cg, cg = self._geometry(stacked.shape[1:])
        if self.fmt == "huggingface":  # [n, L, N, H, T, D] token-major
            stacked = stacked.transpose(3, 4)

        # streams in (half, chunk, layer, group) order; a stream is g
        # adjacent channels of a [C, T] plane: [n * L, C, T] viewed as
        # [n * L, Cg, g * T]
        streams = torch.empty((N, n * L, C, T), dtype=torch.uint8,
                              device=stacked.device)
        maxes_h, cdfs = [], []
        for hi, bins in enumerate(self._bins(cg, N, stacked.device)):
            x = stacked[:, :, hi].reshape(n * L, T, C)
            sym, maxes = quant.quantize(x, bins.repeat(n))
            streams[hi].copy_(sym.transpose(1, 2))
            cdfs.append(quant.compute_cdf(
                streams[hi].view(n * L, Cg, g * T).transpose(1, 2)))
            maxes_h.append(maxes[..., 0].cpu().numpy().reshape(n, L, T))
        payload, lens, cdf_h = self._encode_streams(
            streams.view(N * n * L * Cg, g * T),
            torch.cat(cdfs).reshape(N * n * L * Cg, _MAX_BINS + 1))
        lens = lens.astype(np.uint32).reshape(N, n, L * Cg)
        cdf_h = cdf_h.reshape(N, n, L, Cg, _MAX_BINS + 1)
        # bytes of each (half, chunk) in the payload, and where they end
        sizes = lens.sum(axis=2, dtype=np.int64).reshape(-1)
        ends = np.cumsum(sizes)
        starts = ends - sizes

        dtype_bytes = dtype_name(stacked.dtype).encode("ascii")
        return [self._container(
            L, N, T, H, D, g, cg, dtype_bytes,
            [(maxes_h[hi][ci], cdf_h[hi, ci], lens[hi, ci],
              payload[starts[hi * n + ci]:ends[hi * n + ci]])
             for hi in range(N)]) for ci in range(n)]


class CacheGenHostChunk:
    """A parsed but undecoded CacheGen container (host memory only).

    The retrieval path yields these instead of decoded KV blobs so that
    range decoding and dequantization of many chunks run as one batch on
    the card (:func:`finish_host_chunks`). Parsing makes numpy views over
    the wire bytes; nothing is copied or launched here.

    ``tok_start``/``tok_stop`` implement the retrieval contract's token
    slicing lazily: the whole chunk still decodes (entropy streams are not
    seekable) but the finished blob is sliced before it is returned.
    ``decode_mode`` and ``device`` are stamped by the deserializer that
    parsed the chunk: where its range decode runs and where its blob lands
    unless the finisher's caller names a device.
    """

    __slots__ = ("payload", "lens", "cdf", "maxes", "key_bins",
                 "value_bins", "L", "H", "D", "T", "g", "N", "fmt",
                 "dtype", "tok_start", "tok_stop", "decode_mode", "device")

    def __init__(self, payload, lens, cdf, maxes, key_bins, value_bins,
                 L, H, D, T, g, N, fmt, dtype,
                 tok_start=0, tok_stop=None, decode_mode="auto",
                 device="cuda"):
        self.payload = payload  # bytes/memoryview: all streams, K then V
        self.lens = lens  # u32 [N, L*Cg]
        self.cdf = cdf  # u16 [N, L*Cg, 33]
        self.maxes = maxes  # f32 [N, L, T]
        self.key_bins = key_bins  # u8 [L]
        self.value_bins = value_bins
        self.L, self.H, self.D, self.T = L, H, D, T
        self.g, self.N = g, N
        self.fmt = fmt
        self.dtype = dtype
        self.tok_start = tok_start
        self.tok_stop = T if tok_stop is None else tok_stop
        self.decode_mode = decode_mode
        self.device = device

    @property
    def num_tokens(self) -> int:
        return self.tok_stop - self.tok_start

    @property
    def nbytes(self) -> int:
        return len(self.payload) + self.cdf.nbytes + self.maxes.nbytes

    def slice_tokens(self, start: int, stop: Optional[int] = None):
        """View of tokens [start, stop) relative to current window."""
        new_stop = (self.tok_stop if stop is None
                    else min(self.tok_start + stop, self.tok_stop))
        out = CacheGenHostChunk(
            self.payload, self.lens, self.cdf, self.maxes, self.key_bins,
            self.value_bins, self.L, self.H, self.D, self.T, self.g,
            self.N, self.fmt, self.dtype,
            tok_start=self.tok_start + start, tok_stop=new_stop,
            decode_mode=self.decode_mode, device=self.device)
        if out.num_tokens < 0:
            raise ValueError("slice_tokens out of range")
        return out

    def to_blob(self):
        return finish_host_chunks([self])

    @staticmethod
    def finish_concat(chunks: Sequence["CacheGenHostChunk"], fmt: str):
        """kv.concat_blobs hook: batch-decode a run of host chunks
        (mixed shapes allowed: the trailing chunk may be short)."""
        return finish_mixed_chunks(list(chunks))


def _parse_container(bs) -> CacheGenHostChunk:
    magic, version, fmt_code, dlen = _HDR.unpack_from(bs, 0)
    if magic != MAGIC:
        raise ValueError("Not an LMCG container")
    if version not in (1, 2, 3):
        raise ValueError(f"Unsupported CacheGen container v{version}")
    off = _HDR.size
    dtype = bytes(bs[off:off + dlen]).decode("ascii")
    off += dlen
    L, H, D, T = _GEOM.unpack_from(bs, off)
    off += _GEOM.size
    C = H * D

    key_bins = np.frombuffer(bs, np.uint8, L, off)
    off += L
    value_bins = np.frombuffer(bs, np.uint8, L, off)
    off += L
    g = 1
    if version >= 2:
        (g,) = struct.unpack_from("<B", bs, off)
        off += 1
    N = 2
    if version >= 3:
        (N,) = struct.unpack_from("<B", bs, off)
        off += 1
    if g < 1 or C % g:
        raise ValueError(f"Corrupt LMCG container: group {g} "
                         f"does not divide {C} channels")
    if N not in (1, 2):
        raise ValueError(f"Corrupt LMCG container: {N} streams")
    Cg = C // g
    maxes = np.frombuffer(bs, np.float32, N * L * T, off).reshape(N, L, T)
    off += maxes.nbytes
    cdf = np.frombuffer(bs, np.uint16, N * L * Cg * (_MAX_BINS + 1),
                        off).reshape(N, L * Cg, _MAX_BINS + 1)
    off += cdf.nbytes
    lens = np.frombuffer(bs, np.uint32, N * L * Cg, off).reshape(N, L * Cg)
    off += lens.nbytes
    # a CDF row of a valid container starts at 0 and rises strictly over
    # its 32 stored bounds (the 33rd, 65536, wraps to 0 and is never read);
    # a zero-width bin could collapse the decoder's range
    if ((cdf[..., 0] != 0).any()
            or (cdf[..., 1:_MAX_BINS] <= cdf[..., :_MAX_BINS - 1]).any()):
        raise ValueError("Corrupt LMCG container: a CDF row does not rise "
                         "strictly from 0")

    # a truncated or corrupt container fails here, not as a read past the
    # payload in the decoder
    if off + int(lens.sum()) > len(bs):
        raise ValueError(
            f"Corrupt LMCG container: streams claim "
            f"{int(lens.sum())} payload bytes but only "
            f"{len(bs) - off} remain")
    payload = memoryview(bs)[off:off + int(lens.sum())]
    return CacheGenHostChunk(payload, lens, cdf, maxes, key_bins,
                             value_bins, L, H, D, T, g, N,
                             _FMT_NAME[fmt_code], dtype)


def symbols_to_blob(sym: torch.Tensor, maxes: torch.Tensor,
                    half: torch.Tensor, *, nchunks, L, H, D, T, g, N, fmt,
                    dtype, tok_start, tok_stop) -> torch.Tensor:
    """Decoded symbols -> the dequantized wire blob, on ``sym``'s device
    (:func:`range_decode.dequantize_symbols` with the container's format
    and dtype names)."""
    return range_decode.dequantize_symbols(
        sym, maxes, half, nchunks=nchunks, L=L, H=H, D=D, T=T, g=g, N=N,
        hf=fmt == "huggingface", dtype=torch_dtype(dtype),
        tok_start=tok_start, tok_stop=tok_stop)


def finish_host_chunks(chunks: List[CacheGenHostChunk],
                       mode: Optional[str] = None,
                       device=None) -> torch.Tensor:
    """Decode and dequantize a token-consecutive run of same-shape host
    chunks in one batch on ``device`` (default: the device stamped on the
    chunks): one upload of the still-coded payload, CDF tables, offsets and
    maxes, then one range decode and dequantization of every stream of
    every chunk.

    mode: None uses the mode stamped on the chunks (the config's
    ``cachegen_device_decode``); ``"auto"``/``"on"`` decode where the blob
    lands: on the card one launch of row 11's fused entry, which writes the
    blob (:func:`range_decode.decode_to_blob`), on the CPU its plain
    version; ``"off"`` decodes with the host C++ coder and uploads the
    symbols for :func:`symbols_to_blob`.
    """
    first = chunks[0]
    if mode is None:
        mode = first.decode_mode
    if mode not in CODER_MODES:
        raise ValueError(f"Invalid decode mode {mode!r}")
    device = resolve_device(first.device if device is None else device)
    L, H, D, T, g, N = (first.L, first.H, first.D, first.T, first.g,
                        first.N)
    for c in chunks[1:]:
        if (c.L, c.H, c.D, c.T, c.g, c.N, c.fmt, c.dtype) != (
                L, H, D, T, g, N, first.fmt, first.dtype):
            raise ValueError("finish_host_chunks needs uniform chunks; "
                             "use finish_mixed_chunks")
    # interior chunks must be whole (the retrieval contract only clips
    # the first and last chunk)
    for c in chunks[1:]:
        if c.tok_start:
            raise ValueError("non-leading chunk with tok_start set")
    for c in chunks[:-1]:
        if c.tok_stop != T:
            raise ValueError("non-trailing chunk with tok_stop set")

    nchunks = len(chunks)
    n_symbols = g * T
    lens = np.concatenate([np.asarray(c.lens).reshape(-1) for c in chunks])
    cdf = np.concatenate(
        [np.asarray(c.cdf).reshape(-1, _MAX_BINS + 1) for c in chunks])
    maxes = np.stack([np.asarray(c.maxes) for c in chunks])
    halfs = np.stack([
        (np.asarray(first.key_bins, np.int32) // 2 - 1),
        (np.asarray(first.value_bins, np.int32) // 2 - 1),
    ])[:N].astype(np.float32)  # [N, L]
    payload = np.concatenate(
        [np.frombuffer(c.payload, np.uint8) for c in chunks])

    geo = dict(nchunks=nchunks, L=L, H=H, D=D, T=T, g=g, N=N,
               tok_start=chunks[0].tok_start,
               tok_stop=(nchunks - 1) * T + chunks[-1].tok_stop)
    maxes_d = torch.from_numpy(maxes).to(device)
    halfs_d = torch.from_numpy(halfs).to(device)
    if mode == "off":
        sym = torch.from_numpy(range_coder.decode_streams(
            payload, lens, n_symbols, cdf)).to(device)
        return symbols_to_blob(sym, maxes_d, halfs_d, fmt=first.fmt,
                               dtype=first.dtype, **geo)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return range_decode.decode_to_blob(
        torch.from_numpy(payload).to(device),
        torch.from_numpy(offsets).to(device),
        torch.from_numpy(cdf.view(np.int16)).to(device), maxes_d, halfs_d,
        hf=first.fmt == "huggingface", dtype=torch_dtype(first.dtype), **geo)


def finish_mixed_chunks(chunks: List[CacheGenHostChunk],
                        mode: Optional[str] = None):
    """Batch-decode chunks of possibly mixed shapes: each run of
    same-shape chunks is one batch, concatenated after (the trailing chunk
    of a store is the only shape break in practice)."""
    from lmcache_tpu_torch import kv
    runs, cur = [], [chunks[0]]
    for c in chunks[1:]:
        p = cur[-1]
        if (c.T, c.g, c.N, c.L, c.H, c.D) == (p.T, p.g, p.N, p.L, p.H,
                                              p.D) and p.tok_stop == p.T:
            cur.append(c)
        else:
            runs.append(cur)
            cur = [c]
    runs.append(cur)
    blobs = [finish_host_chunks(r, mode=mode) for r in runs]
    if len(blobs) == 1:
        return blobs[0]
    return kv.concat_blobs(blobs, chunks[0].fmt)


class CacheGenDeserializer(Deserializer):

    def __init__(self, config: LMCacheEngineConfig,
                 metadata: LMCacheEngineMetadata):
        self.fmt = metadata.fmt
        self.decode_mode = config.cachegen_device_decode
        self.device = resolve_device(config.remote_device)

    def from_bytes_host(self, bs) -> CacheGenHostChunk:
        """Host phase only: parse the container into numpy views and stamp
        the configured decode mode and device on the chunk. No decode and no
        upload happen here: the consumer batches many chunks into one
        :func:`finish_host_chunks`."""
        chunk = _parse_container(bs)
        chunk.decode_mode = self.decode_mode
        chunk.device = self.device
        return chunk

    @_lmcache_trace_annotate
    def from_bytes(self, bs):
        return finish_host_chunks([_parse_container(bs)],
                                  mode=self.decode_mode, device=self.device)
