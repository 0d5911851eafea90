"""The Triton STD blend kernel (ops/blend_triton.py).

On the CPU the kernel runs through the Pallas interpreter, which these tests
request explicitly; production code never does (see the routing tests). The
kernel's contract: the numpy oracle's sequential float32 blend, bit for bit,
for any number of views, so view batches never change a byte. The compiled
kernel is checked by the `gpu`-marked test here and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.ops import blend_triton, blend_xla
from lfinterpolator_tpu.ops import reference as oracle


def _setup(rng, cols, rows, h, w, v, focus=0.3):
    g = cols * rows
    images = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    se = np.array([0.0, 0.0, cols - 1.0, rows - 1.0], np.float32)
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    )
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    fo = geometry.focused_offsets(offsets, focus)
    shifted = blend_xla.shift_stack(
        blend_xla.to_planar(jnp.asarray(images)), jnp.asarray(fo)
    )
    flat = shifted.reshape(g, -1)
    return images, wm, fo, flat


def _kernel_views(flat, wm, h, w):
    out = blend_triton.blend(
        flat, jnp.asarray(wm.astype(np.float32)), interpret=True
    )
    return np.asarray(out).reshape(wm.shape[0], 3, h, w).transpose(0, 2, 3, 1)


@pytest.mark.parametrize(
    "cols,rows,h,w,v",
    [(2, 2, 5, 9, 3), (3, 3, 7, 13, 5), (5, 5, 6, 11, 17), (9, 9, 4, 23, 2)],
    ids=["g4", "g9", "g25", "g81"],
)
def test_kernel_matches_oracle_exactly(rng, cols, rows, h, w, v):
    """Grid sizes 4..81, view counts below, at and above one view tile,
    unaligned H/W: every byte equals the oracle's sequential f32 loop."""
    images, wm, fo, flat = _setup(rng, cols, rows, h, w, v)
    want = oracle.blend_fixed(images, wm, fo)
    np.testing.assert_array_equal(_kernel_views(flat, wm, h, w), want)


@pytest.mark.parametrize("vb", [1, 2, 3, 7, 16])
def test_view_batches_are_byte_identical(rng, vb):
    """The views rendered in batches of `vb` weight rows equal the one-pass
    render byte for byte (the capacity planner's promise)."""
    h, w, v = 6, 21, 19
    _, wm, _, flat = _setup(rng, 4, 4, h, w, v)
    full = _kernel_views(flat, wm, h, w)
    parts = [
        _kernel_views(flat, wm[v0 : v0 + vb], h, w) for v0 in range(0, v, vb)
    ]
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_rounds_half_to_even_and_clamps():
    """x.5 sums round to the even integer, like jnp.round and the oracle;
    sums outside [0, 255] clamp."""
    flat = jnp.asarray([[1, 3, 5, 255, 7, 0]], jnp.uint8)
    weights = jnp.asarray([[0.5], [1.5], [-1.0]], jnp.float32)
    got = np.asarray(blend_triton.blend(flat, weights, interpret=True))
    x = np.asarray(flat[0], np.float32)
    want = np.clip(np.round(np.asarray(weights) * x[None, :]), 0, 255)
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    assert got[0, :3].tolist() == [0, 2, 2]  # 0.5, 1.5, 2.5


def test_block_v_is_a_power_of_two_at_most_block():
    assert [blend_triton._block_v(v) for v in (1, 2, 3, 5, 16, 17, 64)] == [
        1, 2, 4, 8, 16, 16, 16,
    ]


def test_routes_std_to_compiled_kernel_on_the_gpu(rng, monkeypatch):
    """With a GPU backend the STD blend is the kernel, compiled
    (interpret=False); TEN stays the fp16 contraction."""
    calls = []

    def fake(flat, weights, **kw):
        calls.append(kw)
        return jnp.zeros((weights.shape[0], flat.shape[1]), jnp.uint8)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(blend_triton, "blend", fake)
    _, wm, _, flat = _setup(rng, 2, 2, 4, 8, 3)
    shifted = flat.reshape(4, 3, 4, 8)
    weights = jnp.asarray(wm.astype(np.float32))
    assert blend_xla.blend(shifted, weights, "STD").shape == (3, 3, 4, 8)
    blend_xla.blend(shifted, weights, "TEN")
    assert calls == [{}]


def test_routes_std_to_xla_off_the_gpu(rng, monkeypatch):
    """On the CPU backend the kernel is never traced, so it can never run
    interpreted by accident."""
    calls = []
    monkeypatch.setattr(
        blend_triton, "blend", lambda *a, **k: calls.append(k)
    )
    _, wm, _, flat = _setup(rng, 2, 2, 4, 8, 3)
    blend_xla.blend(
        flat.reshape(4, 3, 4, 8), jnp.asarray(wm.astype(np.float32)), "STD"
    )
    assert calls == []


def test_int32_index_bound_routes_to_xla(monkeypatch):
    """A stack or padded output of 2**31 values or more would overflow the
    kernel's flat int32 indices: such blends stay on XLA even on the GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert blend_triton.available(64, 64, 2**24)
    assert not blend_triton.available(128, 16, 2**24)  # the stack
    assert not blend_triton.available(16, 128, 2**24)  # the output
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert not blend_triton.available(4, 4, 16)


@pytest.mark.gpu
def test_compiled_kernel_matches_oracle():
    """The kernel compiled by Triton for the GPU (no interpreter) against
    the oracle on full-width rows, whole and in view batches of 2;
    chip_smoke.py runs the same check at the headline shape."""
    rng = np.random.default_rng(3)
    h, w, v = 24, 1920, 64
    images, wm, fo, flat = _setup(rng, 8, 8, h, w, v)
    n = blend_triton.batch_mismatches(flat, jnp.asarray(wm.astype(np.float32)))
    assert n == 0
    got = np.asarray(
        blend_triton.blend(flat, jnp.asarray(wm.astype(np.float32)))
    ).reshape(v, 3, h, w).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, oracle.blend_fixed(images, wm, fo))
