"""The port's RGB-D frontend (monorfs_tpu_torch/frontend: fast, latch,
matching, dataset, and the native PNG binding) against the JAX package's on
the same seeded inputs.

Tolerances: FAST keypoints and validity identical, scores to 1e-5; LATCH
descriptors identical except bits whose two SSDs tie within float32 rounding
(torch_parity.LATCH_TIE_RTOL; the count is printed in the assertion);
Hamming distances and kNN matches exact; RANSAC with the JAX draws injected:
the identical inlier mask on the JAX package's own well-posed test data;
convert_tum identical arrays through the native decoder and through the
pure-Python fallback."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu.frontend import dataset as jdataset
from monorfs_tpu.frontend import fast as jfast
from monorfs_tpu.frontend import kinect as jkinect
from monorfs_tpu.frontend import latch as jlatch
from monorfs_tpu.frontend import matching as jmatching

from monorfs_tpu_torch import native
from monorfs_tpu_torch.frontend import dataset, fast, latch, matching
from monorfs_tpu_torch.frontend.latch_table import SAMPLING_POINTS

from torch_parity import jax_ransac, latch_ties

TUM = "assets/tum_real"


def checkerboard_corners(h=120, w=160, seed=0, n=6):
    """Bright square blobs on a dark noisy background (the construction of
    tests/test_frontend.py)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 30.0)
    for _ in range(n):
        cy, cx = rng.integers(30, h - 30), rng.integers(30, w - 30)
        img[cy - 4 : cy + 4, cx - 4 : cx + 4] = 220.0
    return (img + rng.normal(size=(h, w)) * 2.0).astype(np.float32)


def _tum_frame(i=0):
    """Frame i of assets/tum_real as the converter makes its gray image."""
    rgb = dataset._load_png_py(open(f"{TUM}/{dataset._read_index(f'{TUM}/rgb.txt')[i][1]}", "rb").read())
    gray = rgb.mean(axis=-1).astype(np.uint8) if rgb.ndim == 3 else rgb.astype(np.uint8)
    return gray.astype(np.float32)


IMAGES = {"checkerboard": lambda: (checkerboard_corners(), 40.0, 64, 8),
          "tum_real": lambda: (_tum_frame(3), 40.0, 128, 24)}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detect(name):
    img, thr, k, border = IMAGES[name]()
    jxy, jscore, jvalid = jfast.detect(jnp.asarray(img), threshold=thr, max_keypoints=k, border=border)
    txy, tscore, tvalid = fast.detect(torch.tensor(img), threshold=thr, max_keypoints=k, border=border)
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore), rtol=1e-5, atol=1e-5)
    assert tvalid.sum() >= 6
    # equal scores keep row-major order, as the JAX package's stable argsort does
    flat = (txy[:, 1] * img.shape[1] + txy[:, 0]).numpy()
    same = tscore.numpy()[1:] == tscore.numpy()[:-1]
    assert (flat[1:][same] > flat[:-1][same]).all()
    np.testing.assert_array_equal(fast.fast_score(torch.tensor(img), thr).numpy(),
                                  np.asarray(jfast.fast_score(jnp.asarray(img), thr)))


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_describe(name):
    """The port's LATCH against the JAX extractor's (jitted, as the JAX
    source runs it): bits differ only at SSD ties."""
    img, thr, k, border = IMAGES[name]()
    feats = jkinect.make_extractor(threshold=thr, max_keypoints=k, border=border)(jnp.asarray(img))
    xy, valid = torch.tensor(np.asarray(feats.xy)), torch.tensor(np.asarray(feats.valid))
    desc = latch.describe(torch.tensor(img), xy, valid)
    flips = latch_ties(latch.ssd_pairs, torch.tensor(img), xy, desc.numpy(), np.asarray(feats.desc))
    assert flips <= int(valid.sum()) * 256 // 1000, flips
    # eager JAX too, and the unpacked bits against the SSDs themselves
    jdesc = np.asarray(jlatch.describe(jnp.asarray(img), feats.xy, feats.valid))
    latch_ties(latch.ssd_pairs, torch.tensor(img), xy, desc.numpy(), jdesc)
    a, c = latch.ssd_pairs(torch.tensor(img), xy)
    bits = np.unpackbits(desc.numpy(), axis=1).astype(bool)
    np.testing.assert_array_equal(bits[valid.numpy()], (a < c).numpy()[valid.numpy()])
    assert (desc.numpy()[~valid.numpy()] == 0).all()


def test_blur_and_table():
    img = checkerboard_corners()
    np.testing.assert_allclose(latch.blur3(torch.tensor(img)).numpy(),
                               np.asarray(jlatch.blur3(jnp.asarray(img))), rtol=1e-6, atol=1e-4)
    assert len(SAMPLING_POINTS) == 512
    np.testing.assert_array_equal(latch.TRIPLETS, np.asarray(jlatch.TRIPLETS))


def test_hamming_and_knn():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    b = np.concatenate([a[:25] ^ (rng.random((25, 32)) < 0.05) * np.uint8(1),
                        rng.integers(0, 256, (15, 32), dtype=np.uint8)])
    b = b[rng.permutation(len(b))]
    va, vb = rng.random(40) < 0.9, rng.random(40) < 0.9
    np.testing.assert_array_equal(matching.hamming_matrix(torch.tensor(a), torch.tensor(b)).numpy(),
                                  np.asarray(jmatching.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    tm, tok = matching.knn_match(torch.tensor(a), torch.tensor(va), torch.tensor(b), torch.tensor(vb))
    jm, jok = jmatching.knn_match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 10 < tok.sum() < 40


def _jax_draws(key, mask, iterations=64):
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    keys = jax.random.split(key, iterations)
    return np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(4,)))(keys))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_with_injected_draws(seed):
    """The JAX package's RANSAC test data (a translation with outliers) and
    the JAX function's own draws: the identical inlier mask."""
    rng = np.random.default_rng(seed)
    n = 40
    src = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    dst = src + np.float32([5.0, -3.0])
    outliers = rng.choice(n, 8, replace=False)
    dst[outliers] += rng.uniform(20, 40, (8, 2)).astype(np.float32)
    mask = rng.random(n) < 0.9
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jmatching.ransac_homography(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), key))
    idx = _jax_draws(key, mask)
    got = matching.ransac_homography(torch.tensor(src), torch.tensor(dst), torch.tensor(mask), torch.tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[outliers].any() and got.sum() >= mask.sum() - 10
    # the test helper that replays the JAX function with given rows is that function
    np.testing.assert_array_equal(np.asarray(jax_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
                                                        jnp.asarray(idx))[0]), want)


def test_ransac_too_few_inliers_keeps_the_mask():
    src = torch.tensor([[0.0, 0.0], [10, 0], [0, 10], [10, 10], [50, 50]])
    dst = src * torch.tensor([1.0, -1.0]) + 300.0 * torch.arange(5.0)[:, None]
    mask = torch.tensor([True, True, True, False, False])
    idx = torch.zeros((8, 4), dtype=torch.long)
    np.testing.assert_array_equal(matching.ransac_homography(src, dst, mask, idx).numpy(), mask.numpy())


def test_uniform_draws():
    gen = torch.Generator().manual_seed(0)
    draw = matching.uniform_draws(gen)
    mask = torch.tensor([False, True, False, True, True, False])
    idx = draw(mask, 2000)
    assert idx.shape == (2000, 4) and set(idx.unique().tolist()) == {1, 3, 4}
    counts = torch.bincount(idx.reshape(-1), minlength=6)[[1, 3, 4]].double() / idx.numel()
    np.testing.assert_allclose(counts.numpy(), 1 / 3, atol=0.02)
    assert set(draw(torch.zeros(5, dtype=torch.bool), 500).unique().tolist()) == set(range(5))


def test_temporal_filter_with_injected_draws():
    """Frame 2 of the real sequence against frame 1, through both filters with
    the JAX draws."""
    ex_j = jkinect.make_extractor(threshold=40.0, max_keypoints=128)
    f1, f2 = (ex_j(jnp.asarray(_tum_frame(i))) for i in (1, 2))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jmatching.temporal_filter(f2.xy, f2.desc, f2.valid, f1.xy, f1.desc, f1.valid, key))
    t = [torch.tensor(np.asarray(x)) for x in (f2.xy, f2.desc, f2.valid, f1.xy, f1.desc, f1.valid)]
    got = matching.temporal_filter(*t, lambda mask, n: torch.tensor(_jax_draws(key, mask.numpy(), n)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < got.sum() < int(f2.valid.sum())


@pytest.mark.parametrize("decoder", ["native", "fallback"])
def test_convert_tum(decoder, tmp_path, monkeypatch):
    """Three frames of assets/tum_real through both converters: identical
    arrays, by the native decoder and by the pure-Python fallback."""
    if decoder == "fallback":
        monkeypatch.setattr(native, "decode_png", lambda data: None)
    else:
        assert native.available(), "the native decoder did not build"
    jdataset.convert_tum(TUM, str(tmp_path / "jax.npz"), max_frames=3)
    dataset.convert_tum(TUM, str(tmp_path / "port.npz"), max_frames=3)
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    for k in ("time", "depth", "gray"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert got["depth"].shape == (3, 120, 160) and got["depth"].max() > 0
    ds = dataset.RGBDDataset(tmp_path / "port.npz")
    assert len(ds) == 3 and ds.frame(2)[2].dtype == np.uint8


def test_native_binding(tmp_path):
    """The port's own build of native/rfsio.cpp decodes as the fallback does
    and parses doubles."""
    assert native.available() and native._build().parent.name == "native"
    data = open(f"{TUM}/depth/0.000000.png", "rb").read()
    np.testing.assert_array_equal(native.decode_png(data), dataset._load_png_py(data))
    np.testing.assert_array_equal(native.parse_doubles("1 2.5\n-3e2"), [1.0, 2.5, -300.0])


@pytest.mark.parametrize("fn,kw", [("synthesize_rgbd", dict(frames=5, h=60, w=80, seed=3, flat_depth=1.5)),
                                   ("synthesize_rgbd_parallax", dict(frames=5, h=60, w=80, seed=2))])
def test_synthesizers(fn, kw, tmp_path):
    """The port's NumPy copies of the synthetic sequences: identical arrays."""
    _, want_truth = getattr(jdataset, fn)(tmp_path / "jax.npz", **kw)
    _, got_truth = getattr(dataset, fn)(tmp_path / "port.npz", **kw)
    np.testing.assert_array_equal(got_truth, want_truth)
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    for k in ("time", "depth", "gray"):
        np.testing.assert_array_equal(got[k], want[k])
