"""Golden tests: focal-stack focus estimation + filter vs the NumPy oracle."""

import numpy as np
import pytest
import jax.numpy as jnp

from lfinterpolator_tpu.core import geometry
from lfinterpolator_tpu.ops import blend_xla, focus, reference as oracle


def _focus_setup(small_lf, start_end):
    images, (cols, rows) = small_lf
    h, w = images.shape[1:3]
    center = geometry.trajectory_center(start_end)
    offsets = geometry.compute_offsets(cols, rows, w, h, 1.0, center)
    ids = geometry.select_focus_views(start_end, cols, rows, 8)
    return images, offsets, ids


def test_estimate_matches_oracle_nonnegative_shifts(small_lf):
    """With focus >= 0 and the center at the grid max corner, all offsets are
    >= 0, so floor == trunc everywhere and the fast path must match the
    oracle exactly."""
    start_end = np.array([3.0, 3.0, 3.0, 3.0], dtype=np.float32)
    images, offsets, ids = _focus_setup(small_lf, start_end)
    assert (offsets[ids] >= 0).all()
    radius, steps = (2, 2), 8
    fconf = (0.0, 0.5)

    want = oracle.focus_map_estimate(
        images, offsets, ids, fconf[0], fconf[1], radius, steps=steps
    )
    sel = blend_xla.to_planar(jnp.asarray(images))[jnp.asarray(ids)]
    got = np.asarray(
        focus.estimate_focus_map(
            sel,
            jnp.asarray(offsets[ids]),
            jnp.float32(fconf[0]),
            jnp.float32(fconf[1]),
            radius,
            steps=steps,
            exact_taps=False,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_estimate_matches_oracle_interior_mixed_shifts(small_lf):
    """With a centered trajectory, offsets have both signs; the fast path may
    differ from the oracle only in a border band."""
    start_end = np.array([0.0, 0.0, 3.0, 3.0], dtype=np.float32)
    images, offsets, ids = _focus_setup(small_lf, start_end)
    radius, steps = (2, 2), 8
    fconf = (0.0, 0.5)

    want = oracle.focus_map_estimate(
        images, offsets, ids, fconf[0], fconf[1], radius, steps=steps
    )
    sel = blend_xla.to_planar(jnp.asarray(images))[jnp.asarray(ids)]
    got = np.asarray(
        focus.estimate_focus_map(
            sel,
            jnp.asarray(offsets[ids]),
            jnp.float32(fconf[0]),
            jnp.float32(fconf[1]),
            radius,
            steps=steps,
            exact_taps=False,
        )
    )
    h, w = want.shape
    # Border band where per-pixel truncation can deviate from constant shifts:
    # max shift magnitude + stencil radius.
    b = 12
    np.testing.assert_array_equal(got[b : h - b, b : w - b], want[b : h - b, b : w - b])
    assert (got == want).mean() > 0.9


def test_filter_matches_oracle_exactly(rng):
    m = rng.integers(0, 256, size=(30, 44), dtype=np.uint8)
    for radius in [(1, 1), (2, 1), (3, 4)]:
        want = oracle.focus_map_filter(m, radius)
        got = np.asarray(focus.filter_focus_map(jnp.asarray(m), radius))
        np.testing.assert_array_equal(got, want, err_msg=f"radius={radius}")


def test_filter_zero_radius_copies(rng):
    m = rng.integers(0, 256, size=(8, 8), dtype=np.uint8)
    got = np.asarray(focus.filter_focus_map(jnp.asarray(m), (0, 2)))
    np.testing.assert_array_equal(got, m)


def test_round_half_away_jnp():
    x = jnp.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5])
    got = np.asarray(focus.round_half_away(x))
    np.testing.assert_array_equal(got, [1, 2, 3, -1, -2, 127, 128])


def test_estimate_padded_fast_matches_general(small_lf):
    """The pre-padded approximate path must equal the concat-based general
    path (both use the constant-floor tap rule)."""
    start_end = np.array([0.0, 0.0, 3.0, 3.0], dtype=np.float32)
    images, offsets, ids = _focus_setup(small_lf, start_end)
    radius, steps = (2, 2), 8
    sel = blend_xla.to_planar(jnp.asarray(images))[jnp.asarray(ids)]
    soff = jnp.asarray(offsets[ids])
    base = np.asarray(focus.estimate_focus_map(
        sel, soff, jnp.float32(0.0), jnp.float32(0.5), radius, steps=steps,
        exact_taps=False,
    ))
    pad = focus.shift_pad_bound(offsets, 0.0, 0.5, radius, images.shape[1], images.shape[2])
    fast = np.asarray(focus.estimate_focus_map(
        sel, soff, jnp.float32(0.0), jnp.float32(0.5), radius, steps=steps,
        pad=pad, exact_taps=False,
    ))
    np.testing.assert_array_equal(fast, base)


def test_estimate_exact_taps_matches_oracle(small_lf):
    """exact_taps=True must reproduce the oracle map bit-for-bit, including
    the sign-boundary bands where the approximate rule flips argmins."""
    start_end = np.array([0.0, 0.0, 3.0, 3.0], dtype=np.float32)
    images, offsets, ids = _focus_setup(small_lf, start_end)
    h, w = images.shape[1:3]
    radius, steps = (2, 2), 8
    fconf = (0.05, 0.5)  # mixed-sign shifts around the grid center
    want = oracle.focus_map_estimate(
        images, offsets, ids, fconf[0], fconf[1], radius, steps=steps
    )
    sel = blend_xla.to_planar(jnp.asarray(images))[jnp.asarray(ids)]
    pad = focus.shift_pad_bound(offsets, fconf[0], fconf[1], radius, h, w)
    got = np.asarray(focus.estimate_focus_map(
        sel, jnp.asarray(offsets[ids]),
        jnp.float32(fconf[0]), jnp.float32(fconf[1]), radius, steps=steps,
        pad=pad, exact_taps=True,
    ))
    np.testing.assert_array_equal(got, want)


def test_shift_pad_bound_properties():
    offs = np.array([[100.0, -50.0], [-30.0, 20.0]], np.float32)
    px, py = focus.shift_pad_bound(offs, 0.5, 0.5, (4, 2), h=200, w=300)
    assert px >= 100 + 4 and py >= 50 + 2  # covers max |f*off| + radius
    assert px % 64 == 0 and py % 64 == 0
    # capped near the image size for absurd shifts
    px2, py2 = focus.shift_pad_bound(offs, 100.0, 0.0, (4, 2), h=50, w=60)
    assert px2 <= 60 + 4 + 64 and py2 <= 50 + 2 + 64


def test_estimate_exact_with_shifts_beyond_image(rng):
    """Shifts larger than the image: the pad cap must keep every stencil tap
    border-exact (regression for a review finding where the cap at the image
    size corrupted taps within radius of the border)."""
    h = w = 16
    g = 4
    images = rng.integers(0, 256, size=(g, h, w, 4), dtype=np.uint8)
    offsets = np.array(
        [[1.0, -1.5], [-1.0, 1.5], [1.5, 1.0], [-1.5, -1.0]], np.float32
    )
    ids = np.arange(g, dtype=np.int32)
    radius, steps = (3, 3), 8
    f0, frange = 10.0, 20.0  # max |shift| = 45 > 16
    want = oracle.focus_map_estimate(
        images, offsets, ids, f0, frange, radius, steps=steps
    )
    pad = focus.shift_pad_bound(offsets, f0, frange, radius, h, w)
    sel = blend_xla.to_planar(jnp.asarray(images))
    got = np.asarray(focus.estimate_focus_map(
        sel, jnp.asarray(offsets), jnp.float32(f0), jnp.float32(frange),
        radius, steps=steps, pad=pad, exact_taps=True,
    ))
    np.testing.assert_array_equal(got, want)


def test_estimate_exact_requires_pad():
    import pytest
    sel = jnp.zeros((2, 3, 8, 16), jnp.uint8)
    offs = jnp.ones((2, 2), jnp.float32)
    with pytest.raises(ValueError, match="exact_taps requires"):
        focus.estimate_focus_map(
            sel, offs, jnp.float32(0.0), jnp.float32(1.0), (2, 2), steps=4
        )


@pytest.mark.full
def test_estimate_focus_rows_blocks_match_full(rng):
    """pipeline.estimate_focus_rows (row-slab mode: each block's pad window
    rebuilt from the selected views) concatenates to exactly the full
    estimate, for both tap rules, across block sizes with clipped pads and
    a non-divisor tail."""
    import jax.numpy as jnp

    from lfinterpolator_tpu.core import geometry
    from lfinterpolator_tpu.models import pipeline

    k, c, h, w = 6, 3, 52, 70
    sel = jnp.asarray(rng.integers(0, 256, (k, c, h, w), dtype=np.uint8))
    se = geometry.parse_trajectory("0,0,2,2", (3, 3))
    offsets = geometry.compute_offsets(
        3, 3, w, h, 1.0, geometry.trajectory_center(se)
    )[:k]
    radius = geometry.block_radius(w, h)
    pad = focus.shift_pad_bound(offsets, 0.1, 0.3, radius, h, w)
    offj = jnp.asarray(offsets)
    f, fr = jnp.float32(0.1), jnp.float32(0.3)
    py = max(pad[1], radius[1] + 1)  # the estimate's effective pad floor
    for exact in (True, False):
        full = np.asarray(focus.estimate_focus_map(
            sel, offj, f, fr, radius, steps=8, pad=pad, exact_taps=exact
        ))
        for rb in (16, 20):
            outs = []
            r0 = 0
            while r0 < h:
                rc = min(rb, h - r0)
                outs.append(np.asarray(pipeline.estimate_focus_rows(
                    sel, offj, f, fr, r0, radius=radius, steps=8, pad=pad,
                    exact_taps=exact, rc=rc,
                    top=max(0, py - r0), bot=max(0, (r0 + rc + py) - h),
                )))
                r0 += rc
            np.testing.assert_array_equal(
                np.concatenate(outs, axis=0), full,
                err_msg=f"exact={exact} rb={rb}",
            )
