"""Host-side device-memory capacity planning for single-device renders.

The reference CUDA tool simply aborts with cudaErrorMemoryAllocation when a
light field outgrows device memory (no planning analogue -- this module is a
new capability). Every oversized request is caught by host-side arithmetic
BEFORE any device allocation, so a render either fits, batches, or fails
with the arithmetic instead of an out-of-memory error mid-pipeline.

`plan_fixed_render` sizes the fixed-focus pipeline's resident buffers
(raw planar stack, shifted intermediate, the blend's widened operand and
accumulator, blended output) against the device budget and returns one of
two shapes:

  * everything fits  -> no batching (the common case; zero change)
  * output too big   -> render the views in batches, fetching each batch to
                        the host while the next renders

or raises with the arithmetic when even a single-view batch cannot fit, with
a pointer at mesh sharding (parallel/mesh.py splits the stack by rows, so a
multi-device mesh renders outputs no single device can hold).
"""

from __future__ import annotations

import dataclasses
import os


#: Effectively-unbounded budget reported for CPU runs, where host RAM backs
#: the buffers and batching would only slow tests down.
UNBOUNDED = 1 << 62


def device_hbm_bytes() -> int:
    """Device memory budget in bytes, host-side.

    `LFI_HBM_BYTES` overrides (tests use it to force batching on tiny
    inputs); otherwise the accelerator's reported `bytes_limit` -- on the
    GPU the pool JAX preallocated. CPU runs are unbounded. An accelerator
    that reports no limit is an error, not a guess.
    """
    env = os.environ.get("LFI_HBM_BYTES")
    if env:
        return int(env)
    import jax

    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return UNBOUNDED
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"The {dev.platform} device ({dev.device_kind}) reports no "
            f"memory limit; set LFI_HBM_BYTES to its budget in bytes."
        )
    return int(limit)


def _headroom(budget: int) -> int:
    """Slack left for XLA scratch (GEMM workspaces, fusion temporaries),
    allocator fragmentation, and small constants."""
    return min(512 * 2**20, budget // 16)


@dataclasses.dataclass(frozen=True)
class FixedRenderPlan:
    """How to fit one render into device memory."""

    view_batch: int | None  # weight rows per pass; None = all at once
    budget: int  # effective byte budget the plan was sized against
    bytes_unbatched: int  # resident bytes of the plain single-pass render
    # All-focus only: output rows per select block (the per-pixel-focus
    # select runs block by block instead of one full-stack pass). None =
    # whole frame at once.
    row_block: int | None = None
    # All-focus: output rows per ESTIMATE block when its full padded
    # selected-views copy does not fit (pipeline.estimate_focus_rows pads
    # per block instead). None = whole frame at once.
    estimate_row_block: int | None = None

    @property
    def batched(self) -> bool:
        return self.view_batch is not None


def _infeasible(
    what: str, g: int, w: int, h: int, parts: list[tuple[str, int]],
    b_eff: int,
) -> str:
    gib = 2.0**30
    need = ", ".join(f"{n / gib:.2f} GiB {label}" for label, n in parts)
    return (
        f"{what} too large for one device: {g} images of {w}x{h} need "
        f"{need} against a "
        f"{b_eff / gib:.2f} GiB budget, and even a one-view batch does not "
        f"fit. Render with a multi-device mesh (Interpolator(mesh=...) "
        f"shards the stack by rows) or reduce the resolution/grid."
    )


def plan_fixed_render(
    g: int,
    c: int,
    h: int,
    w: int,
    v: int,
    *,
    budget: int | None = None,
) -> FixedRenderPlan:
    """Size the fixed-focus render and pick a fitting view batch.

    Resident buffers, in pipeline order:

      in     [G, C, H, W] uint8        raw planar stack
      shift  [G, C, H, W] uint8        shifted intermediate
      wide   [G, C*H*W] 4 bytes        the blend's widened operand (TEN's
                                       fp16 copy, counted at f32 width, or
                                       the XLA STD contraction's f32 one)
      out    [Vb, C, H, W] uint8       blended batch
      acc    [Vb, C*H*W] float32       the contraction's accumulator

    The GPU's STD kernel (ops/blend_triton.py) holds neither `wide` nor
    `acc`, so its plans are conservative.

    Batched renders keep TWO batch outputs in flight (batch t+1 renders
    while batch t drains to the host), hence the factor 2; the raw stack
    stays resident (every step's shift re-reads it).
    """
    b = (budget if budget is not None else device_hbm_bytes())
    b_eff = b - _headroom(b)
    in_b = g * c * h * w
    wide_b = 4 * in_b
    ov = c * h * w
    acc_v = 4 * c * h * w

    total = in_b + in_b + wide_b + v * (ov + acc_v)
    if total <= b_eff:
        return FixedRenderPlan(None, b_eff, total)
    vb = min(v, (b_eff - 2 * in_b - wide_b) // (2 * ov + acc_v))
    if vb >= 1:
        return FixedRenderPlan(vb, b_eff, total)
    raise ValueError(_infeasible(
        "Light field", g, w, h,
        [("raw", in_b), ("shifted", in_b), ("blend operand", wide_b),
         ("per output view", ov + acc_v)],
        b_eff,
    ))


def plan_allfocus_render(
    g: int,
    k: int,
    c: int,
    h: int,
    w: int,
    v: int,
    *,
    px: int = 1,
    py: int = 1,
    budget: int | None = None,
) -> FixedRenderPlan:
    """Size the all-focus render and pick a fitting view batch.

    Three phases with different residents (uint8 unless noted; px/py is the
    shift-pad bound from focus_ops.shift_pad_bound):

      estimate: in [G, C, H, W] + selected views [K, C, H, W] + maps
                [2, H, W] + the edge-padded copy [K, C, H+2py, W+2px] +
                one selected-scale sweep temporary (the XLA sweep's
                footprint; the GPU kernel's tables are smaller).
      select:   in + maps + the gathered stack [G, C, H, W] + its int32
                gather indices [G, H, W].
      blend:    in + maps + the gathered stack + its 4-byte widened operand
                + per view the output and its float32 accumulator, two
                batch outputs in flight when batching.

    The estimate and select phases are view-independent; batching only
    splits the blend. The estimate's row blocking is decided first (every
    arm needs the maps). When the whole-frame select or blend cannot fit,
    the select runs block by block over output rows (`row_block`).
    """
    b = (budget if budget is not None else device_hbm_bytes())
    b_eff = b - _headroom(b)
    pxe, pye = max(px, 1), max(py, 1)
    in_b = g * c * h * w
    sel_b = k * c * h * w
    sel_pad_b = k * c * (h + 2 * pye) * (w + 2 * pxe)
    maps_b = 2 * h * w

    def _select_keep(rows: int) -> tuple[int, int, int]:
        """(select bytes, blend-resident bytes, bytes per output view) of
        one block of `rows` output rows."""
        got = g * c * rows * w
        select = in_b + maps_b + got + 4 * g * rows * w
        keep = in_b + maps_b + got + 4 * got
        return select, keep, c * rows * w + 4 * c * rows * w

    est_xla_full_b = in_b + sel_b + sel_pad_b + sel_b + maps_b
    select_b, keep_b, ov = _select_keep(h)

    def _msg() -> str:
        return _infeasible(
            "All-focus render", g, w, h,
            [("to estimate the focus map", est_xla_full_b),
             ("for the per-pixel-focus select", select_b),
             ("to blend", keep_b), ("per output view", ov)],
            b_eff,
        )

    def _est_plan() -> tuple[int | None, int]:
        """(est_row_block, estimate-phase bytes); raises when even the
        smallest row block cannot fit (nothing can render then: every arm
        needs the maps). Two consecutive blocks' buffers can overlap in
        flight, hence the factor 2."""
        if est_xla_full_b <= b_eff:
            return None, est_xla_full_b
        rb = (max(h // 2, 8) + 7) // 8 * 8
        while rb >= 8:
            blk = in_b + sel_b + 2 * k * c * (rb + 2 * pye) * (w + 2 * pxe) + maps_b
            if blk <= b_eff:
                return rb, blk
            rb = (rb // 2) // 8 * 8
        raise ValueError(_msg())

    est_rb, estimate_b = _est_plan()

    total = max(estimate_b, select_b, keep_b + v * ov)
    if total <= b_eff and est_rb is None:
        return FixedRenderPlan(None, b_eff, total)
    if max(estimate_b, select_b) <= b_eff:
        vb = min(v, (b_eff - keep_b) // (2 * ov))
        if vb >= 1:
            return FixedRenderPlan(vb, b_eff, total, estimate_row_block=est_rb)
        if total <= b_eff:
            # est_rb is set (else the unbatched return above fired) but two
            # batch outputs in flight don't fit. The whole blend DOES fit
            # as ONE batch of all views (a single batch is never
            # double-buffered).
            return FixedRenderPlan(v, b_eff, total, estimate_row_block=est_rb)

    # Row-block arm: the select gathers and blends block by block, so the
    # full gathered stack and its widened operand never materialize. Two
    # consecutive blocks' buffers can overlap in flight, hence the 2.
    rb = (max(h // 2, 8) + 7) // 8 * 8
    while rb >= 8:
        select_blk, keep_blk, ov_blk = _select_keep(rb)
        got = g * c * rb * w
        if max(select_blk + got, keep_blk + got) <= b_eff:
            vb = min(v, (b_eff - keep_blk - got) // (2 * ov_blk))
            if vb >= 1:
                return FixedRenderPlan(
                    vb, b_eff, total, rb, estimate_row_block=est_rb,
                )
        rb = (rb // 2) // 8 * 8

    raise ValueError(_msg())


def check_capacity(
    resident_bytes: int, what: str, *,
    budget: int | None = None, hint: str | None = None,
) -> None:
    """Raise before any device allocation when `resident_bytes` cannot fit.

    A deliberately LOWER-bound guard for pipelines without a batched
    fallback (all-focus, streaming, mesh shards): it only trips on
    arithmetic certainty, never on an estimate of transient XLA scratch.
    `hint` overrides the default remediation advice (mesh renders must not
    be told to use a mesh).
    """
    b = (budget if budget is not None else device_hbm_bytes())
    b_eff = b - _headroom(b)
    if resident_bytes > b_eff:
        unit, div = (
            ("GiB", 2.0**30) if max(resident_bytes, b_eff) >= 2**30
            else ("MiB", 2.0**20)
        )
        hint = hint or (
            "Render with a multi-device mesh (Interpolator(mesh=...)), use "
            "Interpolator.interpolate (which batches views automatically), "
            "or reduce the resolution/grid."
        )
        raise ValueError(
            f"{what} needs at least {resident_bytes / div:.2f} {unit} of "
            f"device memory against a {b_eff / div:.2f} {unit} budget. {hint}"
        )


#: Remediation advice for PER-DEVICE mesh-shard arithmetic overruns.
MESH_HINT = (
    "Add devices along the mesh's 'space' axis (row sharding divides every "
    "per-shard operand), shrink the replicated stack (fewer grid images or "
    "lower resolution), or render on one device via Interpolator.interpolate "
    "(which batches views and row-blocks automatically)."
)
