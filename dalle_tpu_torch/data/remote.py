"""URL-capable shard resolution with a local download cache (the port's
copy of ``dalle_tpu/data/remote.py``).

The reference streams its dataset from the HF hub (``data.py:34-38`` of
learning-at-home/dalle); this module is the transport underneath
:class:`dalle_tpu_torch.data.dataset.CodesDataset` when the data root is a
URL instead of a local path. Supported references:

- a local file or directory (passes through untouched);
- a single shard URL (``file://`` or ``http(s)://`` ending in
  ``.msgpack``/``.shard``);
- a MANIFEST URL: a text file with one shard URL (or relative name) per
  line, or a JSON array of them — the portable stand-in for "list the
  bucket".

Shards are fetched lazily on first open into ``cache_dir`` (keyed by a
hash of the URL, written atomically) so repeated epochs and co-located
peers reread the local copy. The cache key and the default directory are
the JAX package's, so both packages resolve a URL to the same file.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import urllib.parse
import urllib.request
from typing import Callable, List, Optional

DEFAULT_CACHE = os.path.expanduser("~/.cache/dalle_tpu/shards")
SHARD_SUFFIXES = (".msgpack", ".shard")


def _read_umask() -> int:
    """The process umask without the racy os.umask write-to-read toggle
    (another thread creating a file mid-toggle would get the wrong mode).
    Linux exposes it in /proc/self/status; elsewhere fall back to a
    conservative 0o022."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Umask:"):
                    return int(line.split()[1], 8)
    except OSError:
        pass
    return 0o022


def is_url(ref: str) -> bool:
    return "://" in ref


def _fetch_bytes(url: str) -> bytes:
    """Small-object fetch (manifests). Shards stream via _fetch_to."""
    scheme = urllib.parse.urlparse(url).scheme
    if scheme == "file":
        with open(urllib.parse.urlparse(url).path, "rb") as f:
            return f.read()
    if scheme in ("http", "https"):
        with urllib.request.urlopen(url, timeout=60) as r:  # noqa: S310
            return r.read()
    raise ValueError(f"unsupported shard URL scheme {scheme!r} ({url})")


def _fetch_to(url: str, out_path: str) -> None:
    """Stream ``url`` into ``out_path`` (multi-GB shards must not buffer
    whole in host RAM)."""
    scheme = urllib.parse.urlparse(url).scheme
    if scheme == "file":
        with open(urllib.parse.urlparse(url).path, "rb") as src, \
                open(out_path, "wb") as dst:
            shutil.copyfileobj(src, dst)
        return
    if scheme in ("http", "https"):
        with urllib.request.urlopen(url, timeout=60) as src, \
                open(out_path, "wb") as dst:  # noqa: S310
            shutil.copyfileobj(src, dst)
        return
    raise ValueError(f"unsupported shard URL scheme {scheme!r} ({url})")


def cache_name(url: str) -> str:
    """The cache file name of ``url`` (the JAX package's key)."""
    return (hashlib.sha256(url.encode()).hexdigest()[:24]
            + "_" + os.path.basename(urllib.parse.urlparse(url).path))


def cached_fetch(url: str, cache_dir: Optional[str] = None) -> str:
    """Local path of ``url``, downloading into the cache on first use."""
    cache_dir = cache_dir or DEFAULT_CACHE  # resolved at call time so
    os.makedirs(cache_dir, exist_ok=True)   # tests can repoint the cache
    name = cache_name(url)
    path = os.path.join(cache_dir, name)
    if os.path.exists(path):
        return path
    # unique temp file per fetcher (tempfile.mkstemp): concurrent
    # processes AND threads racing on the same shard each write their own
    # inode; whoever finishes last wins the atomic rename with a complete
    # file either way
    fd, tmp = tempfile.mkstemp(dir=cache_dir,
                               prefix="." + name + ".", suffix=".tmp")
    os.close(fd)
    # mkstemp creates 0600; restore umask-governed permissions so
    # co-located peers under other users can read the shared cache
    os.chmod(tmp, 0o666 & ~_read_umask())
    try:
        _fetch_to(url, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def resolve_shards(ref: str, cache_dir: Optional[str] = None
                   ) -> List[Callable[[], str]]:
    """Lazy shard openers for a data reference (see module docstring).

    Each returned callable yields a LOCAL shard path, fetching through
    the cache on first call — so a manifest of N remote shards costs one
    manifest fetch up front and one shard download per first use.
    """
    if not is_url(ref):
        if os.path.isdir(ref):
            paths = sorted(
                os.path.join(ref, f) for f in os.listdir(ref)
                if f.endswith(SHARD_SUFFIXES))
        else:
            paths = [ref]
        return [lambda p=p: p for p in paths]

    if ref.endswith(SHARD_SUFFIXES):
        return [lambda: cached_fetch(ref, cache_dir)]

    # manifest: JSON array or newline-separated shard references,
    # relative names resolved against the manifest's directory
    text = _fetch_bytes(ref).decode()
    try:
        entries = json.loads(text)
        if not isinstance(entries, list):
            raise ValueError
    except ValueError:
        entries = [ln.strip() for ln in text.splitlines()
                   if ln.strip() and not ln.strip().startswith("#")]
    base = ref.rsplit("/", 1)[0] + "/"
    urls = [e if is_url(e) else urllib.parse.urljoin(base, e)
            for e in entries]
    return [lambda u=u: cached_fetch(u, cache_dir) for u in urls]


def clear_cache(cache_dir: str = DEFAULT_CACHE) -> None:
    shutil.rmtree(cache_dir, ignore_errors=True)
