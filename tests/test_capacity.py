"""Capacity planning + view-batched rendering (core/capacity.py, api.py).

The reference CUDA tool aborts on >VRAM light fields; this build instead
plans host-side (core/capacity.py) and falls back to view-batched rendering
(outputs stream to the host batch by batch). These tests force tiny budgets
via LFI_HBM_BYTES to exercise every plan mode on the small fixture.
"""

import numpy as np
import pytest

from lfinterpolator_tpu.api import Interpolator
from lfinterpolator_tpu.core import capacity
from lfinterpolator_tpu.core.config import RenderConfig
from lfinterpolator_tpu.io.loader import LightField
from lfinterpolator_tpu.streaming import StreamingRenderer

# small_lf geometry (see conftest)
G, C, H, W = 16, 3, 48, 64


def _scan_plans(v=8, budget_hi=None, dims=None):
    """Plans at descending budgets until even one view no longer fits."""
    g, c, h, w = dims or (G, C, H, W)
    full = capacity.plan_fixed_render(
        g, c, h, w, v, budget=1 << 40
    ).bytes_unbatched
    hi = budget_hi or (2 * full)
    out = []
    for b in range(hi, 0, -max(1, full // 400)):
        try:
            out.append(
                (b, capacity.plan_fixed_render(g, c, h, w, v, budget=b))
            )
        except ValueError:
            break
    else:
        pytest.fail("scan never reached the infeasible regime")
    return out


def _first(plans, pred):
    for b, p in plans:
        if pred(p):
            return b, p
    pytest.fail("no plan matched")


def test_plan_modes_are_ordered_by_budget():
    """Descending budget moves monotonically through
    unbatched -> batched -> infeasible, with non-increasing view batches."""
    plans = _scan_plans()
    modes = [int(p.batched) for _, p in plans]
    assert modes == sorted(modes)
    assert set(modes) == {0, 1}, "every mode must be reachable"
    vbs = [p.view_batch for _, p in plans if p.batched]
    assert all(v >= 1 for v in vbs)
    assert vbs == sorted(vbs, reverse=True)


def test_device_hbm_bytes_env_and_cpu(monkeypatch):
    monkeypatch.setenv("LFI_HBM_BYTES", "12345678")
    assert capacity.device_hbm_bytes() == 12345678
    monkeypatch.delenv("LFI_HBM_BYTES")
    assert capacity.device_hbm_bytes() == capacity.UNBOUNDED  # CPU backend


class _FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_device_hbm_bytes_raises_without_limit(monkeypatch, stats):
    """An accelerator that reports no memory limit is an error, never a
    guessed default."""
    import jax

    monkeypatch.delenv("LFI_HBM_BYTES", raising=False)
    monkeypatch.setattr(jax, "local_devices", lambda: [_FakeDevice(stats)])
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        capacity.device_hbm_bytes()


def test_device_hbm_bytes_reads_accelerator_limit(monkeypatch):
    import jax

    monkeypatch.delenv("LFI_HBM_BYTES", raising=False)
    monkeypatch.setattr(
        jax, "local_devices",
        lambda: [_FakeDevice({"bytes_limit": 60 * 2**30})],
    )
    assert capacity.device_hbm_bytes() == 60 * 2**30


def test_check_capacity(monkeypatch):
    capacity.check_capacity(100, "tiny", budget=1 << 30)
    with pytest.raises(ValueError, match="huge thing needs at least"):
        capacity.check_capacity(1 << 40, "huge thing", budget=1 << 30)


@pytest.fixture
def lf(small_lf):
    images, (cols, rows) = small_lf
    return LightField(images=images, cols=cols, rows=rows)


@pytest.mark.parametrize("method", ["TEN", "STD"])
def test_view_batched_interpolate_matches_unbatched(lf, monkeypatch, method):
    """A budget that forces view batches must not change a single byte
    (per-view blends are independent of the batch split)."""
    cfg = RenderConfig(method=method, view_count=8)
    ref = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,3,3", focus=0.05, progress=False
    )

    b, plan = _first(
        _scan_plans(), lambda p: p.batched and p.view_batch <= 3,
    )
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,3,3", focus=0.05, progress=False, benchmark_runs=1
    )
    assert 1 <= plan.view_batch <= 3  # non-divisor batches hit the zero-pad tail
    np.testing.assert_array_equal(out.views, ref.views)
    assert len(out.run_times_s) == 1  # benchmark loop works on host outputs


def test_view_batched_interpolate_batch(lf, monkeypatch):
    """interpolate_batch's fused multi-trajectory pass also falls back to
    view batches when the stacked weight matrix outgrows the budget."""
    cfg = RenderConfig(method="TEN", view_count=8)
    trajs = ["0,0,3,3", "1,1,2,2", "0,0,3,3"]  # one center -> one fused pass
    ref = Interpolator(lf, config=cfg, progress=False).interpolate_batch(
        trajs, focus=0.05, progress=False
    )
    b, _ = _first(_scan_plans(v=24), lambda p: p.batched)
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, progress=False).interpolate_batch(
        trajs, focus=0.05, progress=False
    )
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.views, r.views)


def test_infeasible_render_raises_before_device_work(lf, monkeypatch):
    interp = Interpolator(
        lf, config=RenderConfig(method="TEN", view_count=8), progress=False
    )
    monkeypatch.setenv("LFI_HBM_BYTES", "100000")
    with pytest.raises(ValueError, match="too large for one device"):
        interp.interpolate("0,0,3,3", focus=0.05, progress=False)


def _allfocus_plan_inputs(lf, cfg, traj="0,0,3,3", focus=0.1, frange=0.2):
    """The same (px, py) the Interpolator will plan with, so budget scans
    match the render's actual arithmetic."""
    from lfinterpolator_tpu.core import geometry
    from lfinterpolator_tpu.ops import focus as focus_ops

    se = geometry.parse_trajectory(traj, lf.cols_rows)
    center = geometry.trajectory_center(se)
    offsets = geometry.compute_offsets(
        lf.cols, lf.rows, lf.width, lf.height, cfg.aspect, center
    )
    radius = geometry.block_radius(
        lf.width, lf.height, cfg.pixel_size_factor
    )
    return focus_ops.shift_pad_bound(
        offsets, focus, frange, radius, lf.height, lf.width
    )


def _scan_allfocus_plans(v=8, k=8, px=1, py=1, dims=None, divisor=400):
    g, h, w = dims or (G, H, W)
    full = capacity.plan_allfocus_render(
        g, k, C, h, w, v, px=px, py=py, budget=1 << 40
    ).bytes_unbatched
    out = []
    for b in range(2 * full, 0, -max(1, full // divisor)):
        try:
            out.append(
                (b, capacity.plan_allfocus_render(
                    g, k, C, h, w, v, px=px, py=py, budget=b
                ))
            )
        except ValueError:
            break
    else:
        pytest.fail("scan never reached the infeasible regime")
    return out


@pytest.mark.parametrize("method", ["TEN", "STD"])
@pytest.mark.full
def test_view_batched_allfocus_matches_unbatched(lf, monkeypatch, method):
    """All-focus under a tight budget estimates maps AND the per-pixel
    selected stack once, then batches the blend -- byte-identical views
    AND maps.

    The batched regime only exists where the output term dominates the
    estimate/select phases (the plan correctly refuses budgets the
    view-independent phases cannot fit), so the test needs a large
    view_count relative to the tiny fixture."""
    v = 64
    cfg = RenderConfig(
        method=method, view_count=v, focus_map_views=8,
    )
    ref = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,3,3", focus=0.1, focus_range=0.2, progress=False
    )
    assert ref.maps is not None
    px, py = _allfocus_plan_inputs(lf, cfg)
    b, plan = _first(
        _scan_allfocus_plans(v=v, px=px, py=py),
        # a non-divisor batch exercises the zero-padded trailing rows
        lambda p: p.batched and v % p.view_batch != 0,
    )
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,3,3", focus=0.1, focus_range=0.2, progress=False,
        benchmark_runs=1,
    )
    np.testing.assert_array_equal(out.maps, ref.maps)
    np.testing.assert_array_equal(out.views, ref.views)
    assert len(out.run_times_s) == 1


@pytest.mark.full
def test_view_batched_interpolate_batch_allfocus(lf, monkeypatch):
    """interpolate_batch with focus_range: the group's stacked all-focus
    pass falls back to view batches under pressure -- byte-identical to the
    unbatched batch (shared maps included)."""
    # view_count=24 x 3 same-center trajectories = 72 stacked rows, enough
    # for the output term to dominate the select phase on the fixture
    cfg = RenderConfig(method="STD", view_count=24, focus_map_views=8)
    trajs = ["0,0,3,3", "1,1,2,2", "0,0,3,3"]
    ref = Interpolator(lf, config=cfg, progress=False).interpolate_batch(
        trajs, focus=0.1, focus_range=0.2, progress=False
    )
    assert ref[0].maps is not None
    px, py = _allfocus_plan_inputs(lf, cfg)
    b, plan = _first(
        _scan_allfocus_plans(v=72, px=px, py=py),
        lambda p: p.batched,
    )
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, progress=False).interpolate_batch(
        trajs, focus=0.1, focus_range=0.2, progress=False
    )
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.maps, r.maps)
        np.testing.assert_array_equal(o.views, r.views)


@pytest.mark.parametrize("method", ["TEN", "STD"])
@pytest.mark.full
def test_view_batched_allfocus_row_blocked(lf, monkeypatch, method):
    """Budgets too tight for the full-stack select (its gathered stack and
    widened blend operand) fall back to row-blocked selection: each block
    gathers only its rows -- byte-identical views and maps. Four focus
    views keep the estimate phase below the select/blend phases, as on
    large frames (G >> K)."""
    cfg = RenderConfig(method=method, view_count=8, focus_map_views=4)
    ref = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,3,3", focus=0.1, focus_range=0.2, progress=False
    )
    px, py = _allfocus_plan_inputs(lf, cfg)
    b, plan = _first(
        _scan_allfocus_plans(k=4, px=px, py=py),
        lambda p: p.row_block is not None,
    )
    assert plan.row_block < H  # genuinely block-by-block
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,3,3", focus=0.1, focus_range=0.2, progress=False,
        benchmark_runs=1,
    )
    np.testing.assert_array_equal(out.maps, ref.maps)
    np.testing.assert_array_equal(out.views, ref.views)


@pytest.mark.full
def test_view_batched_allfocus_row_blocked_estimate(rng, monkeypatch):
    """Budgets too tight even for the estimate's full padded selected-views
    copy row-block the estimate as well (estimate_focus_rows pads per
    block) -- byte-identical maps and views."""
    cols = rows = 3
    # h=144 keeps a budget window where the select fits full-frame but the
    # estimate's padded copy must row-block
    h, w, v, k = 144, 120, 8, 9
    images = rng.integers(0, 256, size=(cols * rows, h, w, 4), dtype=np.uint8)
    lf = LightField(images=images, cols=cols, rows=rows)
    cfg = RenderConfig(method="STD", view_count=v, focus_map_views=k)
    ref = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,2,2", focus=0.1, focus_range=0.2, progress=False
    )
    px, py = _allfocus_plan_inputs(lf, cfg, traj="0,0,2,2")
    plans = _scan_allfocus_plans(
        v=v, k=k, px=px, py=py, dims=(cols * rows, h, w), divisor=2000
    )
    # The estimate's blocking is decided independently of the select's, so
    # the first pressured regime may block ONLY the estimate (full-frame
    # select, batched blend).
    b, plan = _first(plans, lambda p: p.estimate_row_block is not None)
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,2,2", focus=0.1, focus_range=0.2, progress=False
    )
    np.testing.assert_array_equal(out.maps, ref.maps)
    np.testing.assert_array_equal(out.views, ref.views)

    # ... and the deepest-pressure feasible plan still renders exactly.
    b2, _ = plans[-1]
    monkeypatch.setenv("LFI_HBM_BYTES", str(b2))
    out2 = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,2,2", focus=0.1, focus_range=0.2, progress=False
    )
    np.testing.assert_array_equal(out2.maps, ref.maps)
    np.testing.assert_array_equal(out2.views, ref.views)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.full
def test_view_batched_allfocus_fused_slab_estimate(rng, monkeypatch, exact):
    """The row-blocked estimate (estimate_focus_rows builds each block's
    padded slab) is byte-identical to the unpressured run for both tap
    rules, on a frame tall enough (h >> 2py) that blocking the estimate
    actually shrinks its padded operand."""
    cols = rows = 3
    h, w, v, k = 512, 256, 4, 4
    images = rng.integers(0, 256, size=(cols * rows, h, w, 4), dtype=np.uint8)
    lf = LightField(images=images, cols=cols, rows=rows)
    cfg = RenderConfig(
        method="STD", view_count=v, focus_map_views=k, focus_steps=8,
        exact_focus_taps=exact,
    )
    ref = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,2,2", focus=0.1, focus_range=0.2, progress=False
    )
    px, py = _allfocus_plan_inputs(lf, cfg, traj="0,0,2,2")
    b, plan = _first(
        _scan_allfocus_plans(
            v=v, k=k, px=px, py=py, dims=(cols * rows, h, w), divisor=4000
        ),
        lambda p: p.estimate_row_block is not None,
    )
    assert plan.estimate_row_block < h
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,2,2", focus=0.1, focus_range=0.2, progress=False
    )
    np.testing.assert_array_equal(out.maps, ref.maps)
    np.testing.assert_array_equal(out.views, ref.views)


def test_allfocus_infeasible_raises(lf, monkeypatch):
    interp = Interpolator(
        lf, config=RenderConfig(view_count=8, focus_map_views=8),
        progress=False,
    )
    monkeypatch.setenv("LFI_HBM_BYTES", "160000")
    with pytest.raises(ValueError, match="All-focus render too large"):
        interp.interpolate(
            "0,0,3,3", focus=0.1, focus_range=0.2, progress=False
        )


@pytest.mark.parametrize(
    "h,w,v", [(45, 130, 5), (40, 160, 3), (56, 64, 1)]
)
def test_view_batched_fuzz_geometries(rng, monkeypatch, h, w, v):
    """Batched == unbatched across unaligned geometries and non-divisor
    batch tails; a single-view render (which cannot batch) renders exactly
    at the tightest budget that still fits it."""
    cols = rows = 3
    images = rng.integers(0, 256, size=(cols * rows, h, w, 4), dtype=np.uint8)
    lf = LightField(images=images, cols=cols, rows=rows)
    cfg = RenderConfig(method="TEN", view_count=v)
    ref = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,2,2", focus=0.07, progress=False
    )
    plans = _scan_plans(v=v, dims=(cols * rows, 3, h, w))
    if v > 1:
        b, _ = _first(plans, lambda p: p.batched and p.view_batch < v)
    else:
        b, plan = plans[-1]
        assert not plan.batched
    monkeypatch.setenv("LFI_HBM_BYTES", str(b))
    out = Interpolator(lf, config=cfg, progress=False).interpolate(
        "0,0,2,2", focus=0.07, progress=False
    )
    np.testing.assert_array_equal(out.views, ref.views)


def test_streaming_capacity_guard(monkeypatch):
    monkeypatch.setenv("LFI_HBM_BYTES", "500000")
    with pytest.raises(ValueError, match="Streaming"):
        StreamingRenderer(
            4, 4, W, H, "0,0,3,3", config=RenderConfig(view_count=8)
        )
