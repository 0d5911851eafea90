"""STD blend kernel for the GPU (Pallas, Triton route).

The reference's Standard kernel (src/kernels.cu:292-310) sums each output
pixel over the grid images one at a time in float32. This kernel keeps that
order: one program per [views, pixels] tile accumulates
`acc += w[v, g] * x[g, p]` for g = 0, 1, ..., G-1 in registers, then rounds
half to even, clamps and stores bytes. No widened operand or float32
accumulator touches device memory.

The fixed order is the point. Every output value is the same chain of f32
multiply-adds whatever the number of views, the view batch or the pixel
block, so a view-batched or row-blocked render is byte-identical to the
one-pass render. A GEMM library instead picks its kernel, and with it the
summation order, by shape. With fp16-quantized weights every product is
exact in f32 (11 + 8 significant bits), so a fused multiply-add rounds like
the separate multiply and add, and the result equals the numpy oracle's
sequential loop (ops/reference.blend_fixed) bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

#: Views x pixels of one program's tile (powers of two for Triton), chosen
#: on the card among tiles of 8-64 views x 256-1024 pixels at 2-8 warps
#: (PERF.md): 16 x 1024 f32 accumulators, 128 registers per thread.
BLOCK_V = 16
BLOCK_P = 1024
NUM_WARPS = 4
NUM_STAGES = 1


def _block_v(v: int) -> int:
    """Views per tile: BLOCK_V, or the next power of two above a smaller V."""
    return min(BLOCK_V, 1 << max(v - 1, 0).bit_length())


def available(g: int, v: int, n: int) -> bool:
    """Whether the compiled kernel serves G images x V views x N values per
    image: only on the GPU backend, and only while its flat int32 indices
    into the stack and the padded output cannot overflow."""
    bv = _block_v(v)
    out = pl.cdiv(v, bv) * bv * pl.cdiv(n, BLOCK_P) * BLOCK_P
    return jax.default_backend() == "gpu" and max(g * n, out) < 2**31


def _kernel(w_ref, x_ref, o_ref, *, g, n, n_pad, nvb, bv):
    # w_ref holds the weights transposed, [G, V padded], so one image's
    # weights for the tile's views are one contiguous load.
    pid = pl.program_id(0)
    vrow = (pid % nvb) * bv + jnp.arange(bv, dtype=jnp.int32)
    pix = (pid // nvb) * BLOCK_P + jnp.arange(BLOCK_P, dtype=jnp.int32)
    # Overhanging pixels recompute the last valid one, so every read stays
    # in bounds; the caller crops them. Without a clamp (whole tiles) Triton
    # sees contiguous, aligned pixels and vectorizes the loads.
    src = pix if n % BLOCK_P == 0 else jnp.minimum(pix, n - 1)

    def image(gi, acc):
        x = x_ref[gi * n + src].astype(jnp.float32)
        wv = w_ref[gi * nvb * bv + vrow]
        return acc + wv[:, None] * x[None, :]

    acc = lax.fori_loop(0, g, image, jnp.zeros((bv, BLOCK_P), jnp.float32))
    o_ref[vrow[:, None] * n_pad + pix[None, :]] = _round_u8(acc)


def _round_u8(a):
    """Clamp to [0, 255] and round half to even, in integer steps (the
    fraction a - trunc(a) is exact in f32 there)."""
    a = jnp.clip(a, 0.0, 255.0)
    t = a.astype(jnp.int32)
    frac = a - t.astype(jnp.float32)
    up = (frac > 0.5) | ((frac == 0.5) & ((t & 1) == 1))
    return (t + up.astype(jnp.int32)).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("interpret",))
def blend(
    flat: jnp.ndarray,  # [G, N] uint8
    weights: jnp.ndarray,  # [V, G] float
    *,
    interpret: bool = False,
) -> jnp.ndarray:
    """views[v, p] = round(sum_g weights[v, g] * flat[g, p]) as [V, N] uint8,
    accumulated in g order. `interpret=True` runs the kernel through the
    Pallas interpreter (CPU tests); otherwise Triton compiles it for the
    GPU."""
    g, n = flat.shape
    v = weights.shape[0]
    bv = _block_v(v)
    nvb, npb = pl.cdiv(v, bv), pl.cdiv(n, BLOCK_P)
    w = jnp.zeros((nvb * bv, g), jnp.float32).at[:v].set(
        weights.astype(jnp.float32)
    )
    n_pad = npb * BLOCK_P
    kernel = functools.partial(_kernel, g=g, n=n, n_pad=n_pad, nvb=nvb, bv=bv)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nvb * bv * n_pad,), jnp.uint8),
        grid=(nvb * npb,),
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        backend="triton",
        interpret=interpret,
        name="lfi_blend_std",
    )(w.T.reshape(-1), flat.reshape(-1))
    return out.reshape(nvb * bv, n_pad)[:v, :n]


def batch_mismatches(flat, weights, batch: int = 2, interpret=False) -> int:
    """Values where the one-pass blend and the same blend in view batches
    of `batch` weight rows disagree (the kernel's contract is 0). The
    compiled-kernel test and chip_smoke.py both run this check."""
    whole = blend(flat, weights, interpret=interpret)
    parts = jnp.concatenate([
        blend(flat, weights[v0 : v0 + batch], interpret=interpret)
        for v0 in range(0, weights.shape[0], batch)
    ])
    return int(jnp.sum(whole != parts))
