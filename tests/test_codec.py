"""Codec tests: native C++ libpng backend vs Pillow fallback."""

import numpy as np
import pytest

from lfinterpolator_tpu.io import codec


def test_pil_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, (24, 32, 4), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    codec._encode_pil(p, img)
    np.testing.assert_array_equal(codec._decode_pil(p), img)


def test_pil_encode_ignores_extension(tmp_path, rng):
    # Atomic writes stage through NAME.tmp; the Pillow fallback must force
    # PNG instead of inferring the format from the staging extension.
    img = rng.integers(0, 256, (8, 16, 4), dtype=np.uint8)
    p = str(tmp_path / "frame.png.tmp")
    codec._encode_pil(p, img)
    np.testing.assert_array_equal(codec._decode_pil(p), img)


def test_decode_missing_file():
    with pytest.raises(RuntimeError, match="Cannot load image"):
        codec._decode_pil("/nonexistent.png")


def test_encode_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError):
        codec.encode_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("op", ["decode", "encode"])
def test_no_codec_is_a_clear_error(tmp_path, rng, monkeypatch, op):
    """Without the native library and without Pillow, reading or writing
    an image fails with an error that names both ways to get a codec."""
    import sys

    p = str(tmp_path / "n.png")
    codec._encode_pil(p, rng.integers(0, 256, (6, 8, 4), dtype=np.uint8))
    monkeypatch.setattr(codec, "_load_native", lambda: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="make -C native.*Pillow"):
        if op == "decode":
            codec.decode(p)
        else:
            codec.encode_png(p, np.zeros((4, 4, 4), np.uint8))


@pytest.mark.skipif(not codec.native_available(), reason="native codec not built")
class TestNative:
    def test_roundtrip(self, tmp_path, rng):
        img = rng.integers(0, 256, (48, 64, 4), dtype=np.uint8)
        p = str(tmp_path / "n.png")
        codec.encode_png(p, img)
        np.testing.assert_array_equal(codec.decode(p), img)

    def test_cross_codec(self, tmp_path, rng):
        """Native-encoded files decode identically through Pillow and back."""
        img = rng.integers(0, 256, (16, 20, 4), dtype=np.uint8)
        p = str(tmp_path / "c.png")
        codec.encode_png(p, img)
        np.testing.assert_array_equal(codec._decode_pil(p), img)
        p2 = str(tmp_path / "c2.png")
        codec._encode_pil(p2, img)
        np.testing.assert_array_equal(codec.decode(p2), img)

    def test_rgb_normalized_to_rgba(self, tmp_path, rng):
        rgb = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        p = str(tmp_path / "rgb.png")
        codec._encode_pil(p, rgb)
        out = codec.decode(p)
        assert out.shape == (8, 8, 4)
        assert (out[:, :, 3] == 255).all()
        np.testing.assert_array_equal(out[:, :, :3], rgb)

    def test_native_decode_failure_falls_back(self, tmp_path):
        bad = str(tmp_path / "bad.png")
        with open(bad, "wb") as f:
            f.write(b"not a png at all")
        with pytest.raises(RuntimeError, match="Cannot load image"):
            codec.decode(bad)

    def test_jpeg_decode_matches_pillow(self, tmp_path, rng):
        """Native libjpeg decode agrees with Pillow on the same file (both
        wrap libjpeg, so the DCT pipeline output is identical)."""
        from PIL import Image

        img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
        p = str(tmp_path / "t.jpg")
        Image.fromarray(img).save(p, quality=92)
        nat = codec.decode(p)
        pil = np.asarray(Image.open(p).convert("RGBA"), dtype=np.uint8)
        assert nat.shape == pil.shape
        assert (nat[:, :, 3] == 255).all()
        np.testing.assert_array_equal(nat, pil)

    def test_jpeg_decode_failure_falls_back(self, tmp_path):
        bad = str(tmp_path / "bad.jpg")
        with open(bad, "wb") as f:
            f.write(b"definitely not a jpeg")
        with pytest.raises(RuntimeError, match="Cannot load image"):
            codec.decode(bad)

    def test_decode_batch_matches_per_image(self, tmp_path, rng):
        from PIL import Image

        if not codec.native_available():
            pytest.skip("native codec not built")
        paths = []
        want = []
        for i in range(6):
            img = rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)
            img[:, :, 3] = 255
            p = str(tmp_path / f"{i:02d}_00.png")
            if i % 2:  # mix formats: JPEG decode must agree with decode()
                p = str(tmp_path / f"{i:02d}_00.jpg")
                Image.fromarray(img[:, :, :3]).save(p, quality=95)
            else:
                codec.encode_png(p, img)
            paths.append(p)
            want.append(codec.decode(p))
        out = np.empty((6, 24, 40, 4), dtype=np.uint8)
        assert codec.decode_batch(paths, out, threads=3)
        np.testing.assert_array_equal(out, np.stack(want))

    def test_decode_batch_resolution_mismatch(self, tmp_path, rng):
        if not codec.native_available():
            pytest.skip("native codec not built")
        a = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (16, 24, 4), dtype=np.uint8)
        pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
        codec.encode_png(pa, a)
        codec.encode_png(pb, b)
        out = np.empty((2, 16, 16, 4), dtype=np.uint8)
        with pytest.raises(ValueError, match="different resolution"):
            codec.decode_batch([pa, pb], out)

    def test_decode_batch_bad_file(self, tmp_path, rng):
        if not codec.native_available():
            pytest.skip("native codec not built")
        good = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
        pg, pbad = str(tmp_path / "g.png"), str(tmp_path / "bad.png")
        codec.encode_png(pg, good)
        with open(pbad, "wb") as f:
            f.write(b"junk")
        out = np.empty((2, 16, 16, 4), dtype=np.uint8)
        with pytest.raises(RuntimeError, match="Cannot load image"):
            codec.decode_batch([pg, pbad], out)

    def test_encode_batch_roundtrip(self, tmp_path, rng):
        if not codec.native_available():
            pytest.skip("native codec not built")
        stack = rng.integers(0, 256, (5, 24, 40, 4), dtype=np.uint8)
        paths = [str(tmp_path / f"{i:02d}.png") for i in range(5)]
        assert codec.encode_batch_png(paths, stack, threads=3)
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(codec.decode(p), stack[i])
        # no staging leftovers
        assert not list(tmp_path.glob("*.tmp"))

    def test_encode_batch_unwritable_path(self, tmp_path, rng):
        if not codec.native_available():
            pytest.skip("native codec not built")
        stack = rng.integers(0, 256, (2, 8, 8, 4), dtype=np.uint8)
        paths = [
            str(tmp_path / "ok.png"),
            str(tmp_path / "nodir" / "x.png"),  # parent missing
        ]
        with pytest.raises(RuntimeError, match="Cannot write image"):
            codec.encode_batch_png(paths, stack)

    def test_encode_batch_rejects_bad_stack(self, tmp_path):
        if not codec.native_available():
            pytest.skip("native codec not built")
        with pytest.raises(ValueError):
            codec.encode_batch_png(
                [str(tmp_path / "a.png")], np.zeros((1, 4, 4, 3), np.uint8)
            )


@pytest.mark.parametrize("channels", [3, 4])
def test_write_views_roundtrip(tmp_path, rng, channels):
    """write_views (batch-encode fast path or per-file fallback) produces
    decodable frames with alpha forced to 255 and no .tmp leftovers."""
    from lfinterpolator_tpu.io import writer

    views = rng.integers(0, 256, (5, 24, 40, channels), dtype=np.uint8)
    if channels == 4:
        views[..., 3] = 255
    out = writer.write_views(str(tmp_path), views, progress=False)
    assert [p.split("/")[-1] for p in out] == [
        f"{i:02d}.png" for i in range(5)
    ]
    for i, p in enumerate(out):
        back = codec.decode(p)
        np.testing.assert_array_equal(back[..., :3], views[i][..., :3])
        assert (back[..., 3] == 255).all()
    assert not list(tmp_path.glob("*.tmp"))


def test_write_views_chunked_staging(tmp_path, rng, monkeypatch):
    """The bounded-staging loop splits big RGB stacks into several
    batch-encode calls and still produces every frame."""
    from lfinterpolator_tpu.io import writer

    if not codec.native_available():
        pytest.skip("native codec not built")
    monkeypatch.setattr(writer, "_BATCH_STAGE_BYTES", 2 * 24 * 40 * 4)
    views = rng.integers(0, 256, (7, 24, 40, 3), dtype=np.uint8)
    calls = []
    real = codec.encode_batch_png

    def spy(paths, stack, threads=None):
        calls.append(len(paths))
        return real(paths, stack, threads)

    monkeypatch.setattr(codec, "encode_batch_png", spy)
    out = writer.write_views(str(tmp_path), views, progress=False)
    assert len(out) == 7 and len(calls) == 4 and calls == [2, 2, 2, 1]
    for i, p in enumerate(out):
        np.testing.assert_array_equal(codec.decode(p)[..., :3], views[i])
