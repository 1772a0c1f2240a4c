"""Ring and Ulysses attention in the port (``dalle_tpu_torch/parallel/
sequence.py``) against the JAX package's ``sp_zoo_attention`` on the same
mesh shapes and inputs, and against the dense masked oracle.

The port's side runs in ``gloo`` groups of CPU processes
(``parallel/launch.spawn``), each rank on its shards of the global
q/k/v; the test assembles the shards. The JAX side runs on the 8 virtual
CPU devices of tests/conftest.py, its gradients by ``jax.vjp`` with the
same cotangent. Tolerance: f32, rtol 1e-5 with atol 1e-5 (JAX's own test
holds its programs to the dense oracle at 2e-5). Every ``ValueError`` of
JAX's ``sp_zoo_attention`` is raised by the port's ``check_sp`` on the
same sizes.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_tpu.models.attention import dense_zoo_attention
from dalle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dalle_tpu.parallel.sequence import sp_zoo_attention as jax_sp
from dalle_tpu_torch.parallel import mesh as tmesh
from dalle_tpu_torch.parallel.launch import spawn
from dalle_tpu_torch.parallel.sequence import check_sp, zigzag_perms

torch.set_num_threads(2)
CHILDREN = str(Path(__file__).with_name("torch_mesh_children.py"))
TEXT, GRID = 16, 4           # T = 16 + 16 = 32
B, H, D = 4, 4, 8
TOL = dict(rtol=1e-5, atol=1e-5)
TYPES = ("full", "axial_row", "axial_col", "conv_like")


def _inputs(tmp_path, seed):
    rng = np.random.RandomState(seed)
    shape = (B, TEXT + GRID * GRID, H, D)
    arrays = {x: rng.randn(*shape).astype(np.float32) for x in "qkvw"}
    path = tmp_path / f"qkvw{seed}.npz"
    np.savez(path, **arrays)
    return arrays, str(path)


def _assemble(results, key, mesh):
    shape = (B, TEXT + GRID * GRID, H, D)
    out = np.zeros(shape, np.float32)
    bl, tl, hl = B // (mesh["dp"] * mesh["fsdp"]), shape[1] // mesh["sp"], \
        H // mesh["tp"]
    for r in results:
        bi, si, ti = (int(c) for c in r["coords"])
        out[bi * bl:(bi + 1) * bl, si * tl:(si + 1) * tl,
            ti * hl:(ti + 1) * hl] = r[key]
    return out


def _jax_mesh(mesh):
    n = mesh["dp"] * mesh["fsdp"] * mesh["tp"] * mesh["sp"]
    return jax_make_mesh(**mesh, devices=jax.devices()[:n])


def _jax(mode, attn_type, mesh, arrays):
    jm = _jax_mesh(mesh)
    q, k, v, w = (jnp.asarray(arrays[x]) for x in "qkvw")

    @jax.jit
    def fn(q, k, v, w):
        out, vjp = jax.vjp(lambda q, k, v: jax_sp(
            q, k, v, mesh=jm, mode=mode, attn_type=attn_type,
            text_len=TEXT, grid=GRID, conv_kernel=3), q, k, v)
        return (out,) + vjp(w)

    return tuple(np.asarray(x) for x in fn(q, k, v, w))


def _dense(attn_type, arrays):
    q, k, v, w = (jnp.asarray(arrays[x]) for x in "qkvw")

    @jax.jit
    def fn(q, k, v, w):
        out, vjp = jax.vjp(lambda q, k, v: dense_zoo_attention(
            q, k, v, attn_type, TEXT, GRID, conv_kernel=3), q, k, v)
        return (out,) + vjp(w)

    return tuple(np.asarray(x) for x in fn(q, k, v, w))


@pytest.mark.parametrize("mesh, cases", [
    # ring at sp 4 and sp 2 without tp; ring with fsdp and tp
    (dict(dp=2, fsdp=1, tp=1, sp=4), [("ring", "full")]),
    (dict(dp=2, fsdp=1, tp=1, sp=2), [("ring", "full")]),
    (dict(dp=1, fsdp=2, tp=2, sp=2),
     [("ring", "full")] + [("ulysses", t) for t in TYPES]),
    # Ulysses over every zoo type (JAX's test_ulysses_matches_dense mesh)
    (dict(dp=2, fsdp=1, tp=2, sp=2),
     [("ulysses", t) for t in TYPES] + [("ring", "full")]),
], ids=["ring-sp4", "ring-sp2", "fsdp2-tp2-sp2", "dp2-tp2-sp2"])
def test_sp_attention_matches_jax_and_dense(tmp_path, mesh, cases):
    arrays, path = _inputs(tmp_path, sum(mesh.values()))
    n = mesh["dp"] * mesh["fsdp"] * mesh["tp"] * mesh["sp"]
    results = spawn(f"{CHILDREN}:sequence", n,
                    dict(mesh=mesh, inputs=path, cases=cases, text=TEXT,
                         grid=GRID), timeout=120)
    for i, (mode, attn_type) in enumerate(cases):
        got = [_assemble(results, f"{key}{i}", mesh)
               for key in ("out", "dq", "dk", "dv")]
        for want in (_jax(mode, attn_type, mesh, arrays),
                     _dense(attn_type, arrays)):
            for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
                np.testing.assert_allclose(
                    g, w, **TOL, err_msg=f"{mode} {attn_type} {name}")


BAD = [
    # (mesh, mode, attn_type, (B, T, H)) -> each JAX ValueError
    (dict(dp=2, fsdp=1, tp=1, sp=4), "ring", "full", (3, 32, 4)),
    (dict(dp=2, fsdp=1, tp=1, sp=4), "ring", "full", (4, 30, 4)),
    (dict(dp=2, fsdp=1, tp=1, sp=4), "ring", "full", (4, 36, 4)),
    (dict(dp=1, fsdp=2, tp=2, sp=2), "ring", "full", (4, 32, 3)),
    (dict(dp=2, fsdp=1, tp=1, sp=4), "ring", "axial_row", (4, 32, 4)),
    (dict(dp=2, fsdp=1, tp=2, sp=2), "ulysses", "full", (4, 32, 2)),
    (dict(dp=2, fsdp=1, tp=1, sp=4), "striped", "full", (4, 32, 4)),
]


@pytest.mark.parametrize("mesh, mode, attn_type, sizes", BAD)
def test_every_jax_value_error_is_raised(mesh, mode, attn_type, sizes):
    b, t, h = sizes
    x = jnp.zeros((b, t, h, D), jnp.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_sp(x, x, x, mesh=_jax_mesh(mesh), mode=mode,
               attn_type=attn_type, text_len=TEXT, grid=GRID)
    with pytest.raises(ValueError) as port_err:
        n = mesh["dp"] * mesh["fsdp"] * mesh["tp"] * mesh["sp"]
        check_sp(tmesh.make_mesh(**mesh, n_devices=n), mode, attn_type, b,
                 t, h)
    assert str(port_err.value) == str(jax_err.value)


def test_zigzag_permutations_are_jax_s():
    """The re-deal's two permutations, by the JAX function's own
    arithmetic, for every ring size up to 8: each a permutation, and
    together they give rank i chunks (i, 2n-1-i)."""
    for n in range(1, 9):
        low, high = zigzag_perms(n)
        assert sorted(d for _, d in low) == list(range(n))
        assert sorted(d for _, d in high) == list(range(n))
        owned = {i: set() for i in range(n)}
        for (s, d) in low:
            owned[d].add(2 * s)
        for (s, d) in high:
            owned[d].add(2 * s + 1)
        assert owned == {i: {i, 2 * n - 1 - i} for i in range(n)}
