"""The JAX package's native libraries, brought up once in every test worker.

The JAX package builds its host range coder (``lmcache_tpu/codec/_lib/``)
and its native transport (``lmcache_tpu/net/_lib/``) at first use. Each
build compiles into one shared temporary name (``<lib>.tmp``) and renames
it, and a process that saw its build fail remembers the failure for its
whole life (``range_coder._build_failed``, ``native._cache[src] = None``).
Test modules of the JAX package ask for both libraries at import, so the
workers of a parallel run start the builds at the same moment while they
collect; on a tree where the libraries are not built yet, the workers race
on the one temporary file and the losers keep "unavailable" for the run.

Every worker imports every test file while it collects, and no test runs
before collection ends. So importing this module brings both libraries up
again, one worker at a time under a file lock: where this process's first
build failed, the failure record is cleared and the build asked for once
more. That retries a build and nothing else: a library that still cannot
be built stays unavailable, and the tests below then fail.

What this cannot recover: the skips that a JAX test module decided at its
own import, before this module was imported.
"""

import fcntl
import os
from pathlib import Path

from lmcache_tpu import native as jax_native
from lmcache_tpu import net as jax_net
from lmcache_tpu.codec import range_coder as jax_coder

# build/ is ignored by git; the lock file lives beside the port's builds
LOCK_PATH = Path(__file__).resolve().parents[1] / "build" / "native_libs.lock"


def bring_up_native_libs():
    """Build (or load) the JAX package's host range coder and native
    transport under an exclusive lock on ``LOCK_PATH``, asking once more for
    a build that this process saw fail. Returns (coder available, transport
    available)."""
    LOCK_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if jax_coder._lib is None and jax_coder._build_failed:
                # the failure record is per process: a lost race on the
                # shared temporary file, not a missing toolchain, set it
                jax_coder._build_failed = False
            coder = jax_coder.codec_available()
            src = os.path.abspath(jax_net._SRC)
            if src in jax_native._cache and jax_native._cache[src] is None:
                del jax_native._cache[src]  # the same, for the transport
            transport = jax_net.native_transport_available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return coder, transport


CODER_UP, TRANSPORT_UP = bring_up_native_libs()


def test_the_host_range_coder_is_up_in_this_worker():
    assert CODER_UP and jax_coder.codec_available()


def test_the_native_transport_is_up_in_this_worker():
    assert TRANSPORT_UP and jax_net.native_transport_available()


def test_a_failed_build_is_asked_for_once_more(monkeypatch):
    # a process that lost the race: its coder and transport records say
    # "failed"; bringing them up again loads the libraries
    monkeypatch.setattr(jax_coder, "_lib", None)
    monkeypatch.setattr(jax_coder, "_build_failed", True)
    src = os.path.abspath(jax_net._SRC)
    monkeypatch.setitem(jax_native._cache, src, None)
    assert not jax_coder.codec_available()
    assert not jax_net.native_transport_available()
    assert bring_up_native_libs() == (True, True)
    assert jax_coder._lib is not None and jax_native._cache[src] is not None
