"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.ops import blend_xla, reference as oracle
from lfinterpolator_tpu.parallel import mesh as pmesh


@pytest.fixture(scope="module")
def devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual devices (see conftest XLA_FLAGS)")
    return d


def _setup(seed=7, cols=2, rows=2, h=32, w=64, v=8):
    rng = np.random.default_rng(seed)
    g = cols * rows
    images = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    se = np.array([0.0, 0.0, cols - 1.0, rows - 1.0], np.float32)
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    fo = geometry.focused_offsets(offsets, 0.4)
    return images, wm, fo


def test_mesh_shapes(devices):
    m = pmesh.make_mesh(devices)
    assert m.shape["view"] * m.shape["space"] == 8
    m1 = pmesh.make_mesh(devices, view_parallel=4)
    assert m1.shape == {"view": 4, "space": 2}


def test_sharded_render_matches_oracle(devices):
    images, wm, fo = _setup()
    m = pmesh.make_mesh(devices, view_parallel=2)
    planar = blend_xla.to_planar(jnp.asarray(images))
    imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
    out = pmesh.render_fixed_sharded(m, imgs_d, w_d, jnp.asarray(fo))
    got = pmesh.gather_views(out)
    want = oracle.blend_fixed(images, wm.astype(np.float16), fo)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1


@pytest.mark.parametrize("view_parallel", [1, 2, 4])
def test_sharded_std_kernel_matches_oracle(devices, monkeypatch, view_parallel):
    """On a GPU each shard's STD blend is the Triton kernel inside
    shard_map; run it (interpreted) per shard and get the oracle's bytes."""
    import functools

    from lfinterpolator_tpu.ops import blend_triton

    images, wm, fo = _setup()
    m = pmesh.make_mesh(devices, view_parallel=view_parallel)
    planar = blend_xla.to_planar(jnp.asarray(images))
    imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
    calls = []
    kernel = functools.partial(blend_triton.blend, interpret=True)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        blend_triton, "blend",
        lambda *a, **k: calls.append(1) or kernel(*a, **k),
    )
    out = pmesh.render_fixed_sharded.__wrapped__(
        m, imgs_d, w_d, jnp.asarray(fo), "STD"
    )
    assert calls
    want = oracle.blend_fixed(images, wm.astype(np.float16), fo)
    np.testing.assert_array_equal(pmesh.gather_views(out), want)


def test_sharded_render_output_sharding(devices):
    images, wm, fo = _setup()
    m = pmesh.make_mesh(devices, view_parallel=2)
    planar = blend_xla.to_planar(jnp.asarray(images))
    imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
    out = pmesh.render_fixed_sharded(m, imgs_d, w_d, jnp.asarray(fo))
    # Output must actually be sharded over (view, space), not replicated.
    sharding = out.sharding
    spec = sharding.spec
    assert spec[0] == "view" and spec[2] == "space"


def test_sharded_matches_all_view_parallel_factors(devices):
    images, wm, fo = _setup(v=16)
    planar = blend_xla.to_planar(jnp.asarray(images))
    ref = None
    for vp in (1, 2, 4, 8):
        m = pmesh.make_mesh(devices, view_parallel=vp)
        imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
        got = pmesh.gather_views(
            pmesh.render_fixed_sharded(m, imgs_d, w_d, jnp.asarray(fo))
        )
        if ref is None:
            ref = got
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"vp={vp}")


def test_sharded_rejects_bad_row_split(devices):
    images, wm, fo = _setup(h=30)  # 30 rows not divisible by 4 shards
    m = pmesh.make_mesh(devices, view_parallel=2)
    planar = blend_xla.to_planar(jnp.asarray(images))
    imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
    with pytest.raises(ValueError, match="must divide"):
        pmesh.render_fixed_sharded(m, imgs_d, w_d, jnp.asarray(fo))


@pytest.mark.full
def test_sharded_all_focus_matches_unsharded(devices, small_lf):
    """Sharded pipeline == unsharded, bit for bit, for both methods and
    both tap rules."""
    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.ops import focus as focus_ops
    from lfinterpolator_tpu.core import geometry

    images, (cols, rows) = small_lf
    h, w = images.shape[1:3]
    se = np.array([0.0, 0.0, 3.0, 3.0], np.float32)
    v = 8
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    ids = geometry.select_focus_views(se, cols, rows, 8)
    radius, frad, steps = (2, 2), (1, 1), 8
    pad = focus_ops.shift_pad_bound(offsets, 0.0, 0.5, radius, h, w)

    planar = blend_xla.to_planar(jnp.asarray(images))
    args = dict(radius=radius, filter_radius=frad, steps=steps)
    for method, exact in (("STD", True), ("TEN", True), ("TEN", False)):
        want_views, want_maps = pipeline.render_all_focus(
            planar, jnp.asarray(wm), jnp.asarray(offsets),
            jnp.float32(0.0), jnp.float32(0.5), jnp.asarray(ids),
            method=method, pad=pad, exact_taps=exact, **args,
        )
        m = pmesh.make_mesh(devices, view_parallel=2)
        imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
        got_views, got_maps = pmesh.render_all_focus_sharded(
            m, imgs_d, w_d, jnp.asarray(offsets),
            jnp.float32(0.0), jnp.float32(0.5), jnp.asarray(ids),
            method=method, pad=pad, exact_taps=exact, **args,
        )
        np.testing.assert_array_equal(
            np.asarray(got_maps), np.asarray(want_maps), err_msg=method
        )
        np.testing.assert_array_equal(
            np.asarray(got_views), np.asarray(want_views), err_msg=method
        )


def test_interpolator_api_with_mesh(devices, tmp_path, small_lf):
    """High-level Interpolator on a mesh matches the single-device result."""
    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu.io import codec, loader

    images, (cols, rows) = small_lf
    d = tmp_path / "scene"
    d.mkdir()
    for c in range(cols):
        for r in range(rows):
            codec.encode_png(str(d / f"{c:02d}_{r:02d}.png"), images[c * rows + r])

    cfg = RenderConfig(view_count=8, focus_map_views=8, focus_steps=8)
    single = Interpolator(str(d), config=cfg, progress=False)
    m = pmesh.make_mesh(devices, view_parallel=2)
    sharded = Interpolator(str(d), config=cfg, progress=False, mesh=m)

    r1 = single.interpolate("0,0,1,1", focus=0.3, progress=False)
    r2 = sharded.interpolate("0,0,1,1", focus=0.3, progress=False)
    diff = np.abs(r1.views.astype(int) - r2.views.astype(int))
    assert diff.max() <= 1  # accumulation-order only

    r3 = single.interpolate("0,0,1,1", focus=0.0, focus_range=0.5, progress=False)
    r4 = sharded.interpolate("0,0,1,1", focus=0.0, focus_range=0.5, progress=False)
    np.testing.assert_array_equal(r3.maps, r4.maps)
    diff = np.abs(r3.views.astype(int) - r4.views.astype(int))
    assert diff.max() <= 1


def test_interpolator_mesh_rejects_bad_height(devices, tmp_path, rng):
    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.io import codec

    d = tmp_path / "scene31"
    d.mkdir()
    img = rng.integers(0, 256, (31, 16, 4), dtype=np.uint8)  # 31 rows: indivisible
    for c in range(2):
        for r in range(2):
            codec.encode_png(str(d / f"{c}_{r}.png"), img)
    m = pmesh.make_mesh(devices, view_parallel=2)
    with pytest.raises(ValueError, match="must divide"):
        Interpolator(str(d), progress=False, mesh=m)


@pytest.mark.parametrize("method", ["STD", "TEN"])
def test_sharded_fixed_matches_unsharded(devices, method):
    """Each shard's row block of the fixed render equals the single-device
    render's rows (the blend contracts only over images, so the row split
    changes nothing but the library's accumulation order)."""
    from lfinterpolator_tpu.models import pipeline

    images, wm, fo = _setup(seed=3, h=32, w=96)
    planar = blend_xla.to_planar(jnp.asarray(images))
    full = np.asarray(pipeline.render_fixed_focus(
        planar, jnp.asarray(wm), jnp.asarray(fo), method=method
    ))
    m = pmesh.make_mesh(devices, view_parallel=2)
    imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
    out = np.asarray(
        pmesh.render_fixed_sharded(m, imgs_d, w_d, jnp.asarray(fo), method)
    )
    assert np.abs(out.astype(int) - full.astype(int)).max() <= 1


def test_interpolate_batch_with_mesh(devices, tmp_path, small_lf):
    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu.io import codec

    images, (cols, rows) = small_lf
    d = tmp_path / "scene"
    d.mkdir()
    for c in range(cols):
        for r in range(rows):
            codec.encode_png(str(d / f"{c:02d}_{r:02d}.png"), images[c * rows + r])
    cfg = RenderConfig(view_count=4, focus_map_views=8)
    m = pmesh.make_mesh(devices, view_parallel=2)
    single = Interpolator(str(d), config=cfg, progress=False)
    sharded = Interpolator(str(d), config=cfg, progress=False, mesh=m)
    trajs = ["0,0,1,1", "0.25,0.25,0.75,0.75"]
    want = single.interpolate_batch(trajs, focus=0.3, progress=False)
    got = sharded.interpolate_batch(trajs, focus=0.3, progress=False)
    for a, b in zip(want, got):
        diff = np.abs(a.views.astype(int) - b.views.astype(int))
        assert diff.max() <= 1

    # all-focus batch: the group shares one sharded estimate; the sharded
    # XLA engines match the single-chip ones exactly
    want_af = single.interpolate_batch(
        trajs, focus=0.1, focus_range=0.2, progress=False
    )
    got_af = sharded.interpolate_batch(
        trajs, focus=0.1, focus_range=0.2, progress=False
    )
    for a, b in zip(want_af, got_af):
        assert a.maps is not None
        np.testing.assert_array_equal(a.maps, b.maps)
        np.testing.assert_array_equal(a.views, b.views)


@pytest.mark.full
def test_multihost_two_process_render():
    """Real 2-process jax.distributed run (4 virtual CPU devices each):
    initialize, shard a render across processes, and fetch through the
    process_allgather branch of api._fetch. Subprocess-spawned
    because a single pytest process can't be two JAX processes."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "_multihost_worker.py")
    env = dict(
        os.environ,
        PYTHONPATH=f"{repo}:{os.environ.get('PYTHONPATH', '')}",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(r), "2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"MULTIHOST_OK rank {r}" in out


def test_interpolate_batch_mesh_matches_solo(devices, tmp_path, small_lf):
    """A mesh batch (one group: same center) matches the individual mesh
    renders exactly."""
    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu.io import codec

    images, (cols, rows) = small_lf
    d = tmp_path / "scene"
    d.mkdir()
    for c in range(cols):
        for r in range(rows):
            codec.encode_png(str(d / f"{c:02d}_{r:02d}.png"), images[c * rows + r])
    cfg = RenderConfig(view_count=8, method="TEN")
    m = pmesh.make_mesh(devices, view_parallel=2)
    sharded = Interpolator(str(d), config=cfg, progress=False, mesh=m)
    trajs = ["0,0,1,1", "0.25,0.25,0.75,0.75"]  # same center -> one group
    batch = sharded.interpolate_batch(trajs, focus=0.3, progress=False)
    for t, res in zip(trajs, batch):
        solo = sharded.interpolate(t, focus=0.3, progress=False)
        assert np.abs(res.views.astype(int) - solo.views.astype(int)).max() <= 1, t


@pytest.mark.full
def test_mesh_allfocus_fused_slab_matches_unsharded(devices):
    """Mesh all-focus through the per-shard slab route (_shard_slab
    clipped-take windows, never the full padded stack) stays bit-identical
    to the single-device pipeline for every shard position (first,
    interior and last edge clamps included)."""
    from lfinterpolator_tpu.models import pipeline
    from lfinterpolator_tpu.ops import focus as focus_ops

    rng = np.random.default_rng(11)
    cols = rows = 2
    g, h, w, v, steps = 4, 128, 256, 8, 8
    # structured content: shifted texture planes give the estimate signal
    tex = rng.integers(0, 256, size=(h + 16, w + 16, 3), dtype=np.uint8)
    images = np.zeros((g, h, w, 4), np.uint8)
    for c in range(cols):
        for r in range(rows):
            images[c * rows + r, :, :, :3] = tex[
                r * 4 : r * 4 + h, c * 4 : c * 4 + w
            ]
            images[c * rows + r, :, :, 3] = 255
    se = np.array([0.0, 0.0, cols - 1.0, rows - 1.0], np.float32)
    wm = geometry.quantize_weights_f16(
        geometry.weight_matrix(se, cols, rows, 3.0, v)
    ).astype(np.float32)
    offsets = geometry.compute_offsets(
        cols, rows, w, h, 1.0, geometry.trajectory_center(se)
    )
    ids = geometry.select_focus_views(se, cols, rows, 4)
    radius, frad = (2, 2), (1, 1)
    pad = focus_ops.shift_pad_bound(offsets, 0.0, 0.5, radius, h, w)
    m = pmesh.make_mesh(devices, view_parallel=2)

    planar = blend_xla.to_planar(jnp.asarray(images))
    args = dict(radius=radius, filter_radius=frad, steps=steps, pad=pad)
    for method in ("TEN", "STD"):
        want_views, want_maps = pipeline.render_all_focus(
            planar, jnp.asarray(wm), jnp.asarray(offsets),
            jnp.float32(0.0), jnp.float32(0.5), jnp.asarray(ids),
            method=method, **args,
        )
        imgs_d, w_d = pmesh.shard_inputs(m, planar, jnp.asarray(wm))
        got_views, got_maps = pmesh.render_all_focus_sharded(
            m, imgs_d, w_d, jnp.asarray(offsets),
            jnp.float32(0.0), jnp.float32(0.5), jnp.asarray(ids),
            method=method, **args,
        )
        np.testing.assert_array_equal(
            np.asarray(got_maps), np.asarray(want_maps), err_msg=method
        )
        np.testing.assert_array_equal(
            np.asarray(got_views), np.asarray(want_views), err_msg=method
        )


def test_allfocus_shard_bytes_8k_feasible():
    """The slab route keeps an 8K/8-device mesh all-focus render inside
    the pool JAX preallocates on an 80 GB card (75%), with an estimate
    phase below the full-frame formulation's per-device operands
    (full-height focus-view gather + full-frame padded copy), as planner
    arithmetic."""
    g, k, c, h, w, v = 64, 32, 3, 4320, 7680, 64
    px = py = 400
    radius = (76, 43)
    budget = 60 * 2**30
    b_eff = budget - min(512 * 2**20, budget // 16)

    phases = pmesh.allfocus_shard_bytes(
        2, 4, g, k, c, h, w, v, radius=radius, pad=(px, py),
    )
    assert phases["peak"] <= b_eff, (
        f"slab-route peak {phases['peak'] / 2**30:.2f} GiB must fit "
        f"{b_eff / 2**30:.2f} GiB"
    )

    # The full-frame formulation's estimate-phase residents per device:
    # replicated stack + full-height focus-view gather + full-frame edge-
    # padded copy + the sweep temporaries (what estimate_focus_map
    # materializes without slab=).
    rx, ry = radius
    pxe, pye = max(px, rx + 1), max(py, ry + 1)
    old_est = (
        g * c * h * w  # replicated stack
        + k * c * h * w  # images[ids] full-height gather
        + k * c * (h + 2 * pye) * (w + 2 * pxe)  # full edge-padded copy
        + 2 * k * c * h * w  # sweep temporaries
    )
    assert phases["estimate"] < old_est


def test_mesh_capacity_check_raises(devices, tmp_path, small_lf, monkeypatch):
    """With a forced tiny HBM budget, mesh renders fail host-side with the
    per-chip arithmetic error (never an OOM on device)."""
    from lfinterpolator_tpu.api import Interpolator
    from lfinterpolator_tpu.core.config import RenderConfig
    from lfinterpolator_tpu.io import codec

    images, (cols, rows) = small_lf
    d = tmp_path / "scene"
    d.mkdir()
    for c in range(cols):
        for r in range(rows):
            codec.encode_png(
                str(d / f"{c:02d}_{r:02d}.png"), images[c * rows + r]
            )
    m = pmesh.make_mesh(devices, view_parallel=2)
    interp = Interpolator(
        str(d), config=RenderConfig(view_count=8, focus_map_views=8),
        progress=False, mesh=m,
    )
    monkeypatch.setenv("LFI_HBM_BYTES", "200000")
    with pytest.raises(ValueError, match="per device"):
        interp.interpolate("0,0,1,1", focus=0.1, focus_range=0.2,
                           progress=False)
    with pytest.raises(ValueError, match="per device"):
        interp.interpolate("0,0,1,1", focus=0.1, progress=False)
