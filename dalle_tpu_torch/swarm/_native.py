"""ctypes binding to the C++ swarm daemon (``native/swarm/swarm.cc``):
the port's own copy of ``dalle_tpu/swarm/_native.py``.

The port builds the same repository source, so that its peers and the JAX
package's speak one protocol, but into its own build directory: ``g++ -O2
-std=c++17 -fPIC -shared -pthread`` writes
``build/dalle_tpu_torch/libdalle_swarm-<hash>.so`` at first use, the hash
being of ``swarm.cc`` and ``swarm.h``; nothing is written under
``native/``. Typed wrappers of the C entry points are set on the loaded
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC_DIR = _REPO_ROOT / "native" / "swarm"
BUILD_DIR = _REPO_ROOT / "build" / "dalle_tpu_torch"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """The library of the current sources (built or not)."""
    digest = hashlib.sha256((_SRC_DIR / "swarm.cc").read_bytes()
                            + (_SRC_DIR / "swarm.h").read_bytes())
    return BUILD_DIR / f"libdalle_swarm-{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(_SRC_DIR / "swarm.cc")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"native swarm build failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """Load (building if needed) the swarm library; idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))

        lib.swarm_node_create.restype = ctypes.c_void_p
        lib.swarm_node_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.swarm_node_port.restype = ctypes.c_int
        lib.swarm_node_port.argtypes = [ctypes.c_void_p]
        lib.swarm_node_bootstrap.restype = ctypes.c_int
        lib.swarm_node_bootstrap.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.swarm_node_store.restype = ctypes.c_int
        lib.swarm_node_store.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_double]
        lib.swarm_node_get.restype = ctypes.c_void_p
        lib.swarm_node_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.swarm_node_send.restype = ctypes.c_int
        lib.swarm_node_send.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        lib.swarm_node_recv.restype = ctypes.c_void_p
        lib.swarm_node_recv.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.swarm_node_post.restype = ctypes.c_int
        lib.swarm_node_post.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_double]
        lib.swarm_node_fetch.restype = ctypes.c_void_p
        lib.swarm_node_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]
        lib.swarm_node_attach_relay.restype = ctypes.c_int
        lib.swarm_node_attach_relay.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.swarm_node_relay_send.restype = ctypes.c_int
        lib.swarm_node_relay_send.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        lib.swarm_node_relay_fetch.restype = ctypes.c_void_p
        lib.swarm_node_relay_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]
        lib.swarm_node_punch_prepare.restype = ctypes.c_int
        lib.swarm_node_punch_prepare.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p]
        lib.swarm_node_punch_connect.restype = ctypes.c_int
        lib.swarm_node_punch_connect.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int]
        lib.swarm_node_has_direct.restype = ctypes.c_int
        lib.swarm_node_has_direct.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p]
        lib.swarm_node_relay_served.restype = ctypes.c_uint64
        lib.swarm_node_relay_served.argtypes = [ctypes.c_void_p]
        lib.swarm_node_observed_host.restype = ctypes.c_void_p
        lib.swarm_node_observed_host.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
        lib.swarm_node_peers.restype = ctypes.c_void_p
        lib.swarm_node_peers.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
        lib.swarm_node_set_timeout.restype = None
        lib.swarm_node_set_timeout.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.swarm_node_destroy.restype = None
        lib.swarm_node_destroy.argtypes = [ctypes.c_void_p]
        lib.swarm_free.restype = None
        lib.swarm_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def take_buffer(ptr: int, length: int) -> bytes:
    """Copy a malloc'd native buffer into bytes and free it."""
    lib = load()
    try:
        return ctypes.string_at(ptr, length)
    finally:
        lib.swarm_free(ptr)
