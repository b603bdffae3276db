"""Descriptor matching and temporal consistency filtering: the torch twin of
monorfs_tpu.frontend.matching (reference: KinectVehicle.cs:503-576, kNN
Hamming matching with normalised threshold 0.37 against the previous frame,
then a RANSAC homography inlier filter).

Hamming distances are one XOR + popcount-table reduction; RANSAC runs a fan
of 64 four-point hypotheses at once (batched DLT null vectors). Randomness
is injected: ransac_homography takes the hypotheses' sample indices as a
tensor, and temporal_filter a `draw(mask, iterations)` callable that makes
them (uniform_draws over a torch.Generator by default)."""

import functools

import numpy as np
import torch

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.int64)
ITERATIONS = 64


@functools.cache
def _popcount(device):
    return torch.as_tensor(_POPCOUNT, device=device)


def hamming_matrix(desc_a, desc_b):
    """[KA, KB] Hamming distances between uint8 descriptor sets (exact)."""
    x = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return torch.sum(_popcount(desc_a.device)[x.long()], dim=-1)


def knn_match(desc_a, valid_a, desc_b, valid_b, max_norm_distance=0.37):
    """Best match (within the threshold) of each descriptor of A in B
    (KinectVehicle.cs:510-527: k=3 plus the threshold, of which only the
    thresholded best match counts). Ties go to the first index. Returns
    (match_idx [KA], matched [KA])."""
    nbits = desc_a.shape[1] * 8
    d = hamming_matrix(desc_a, desc_b)
    d = torch.where(valid_b[None, :], d, torch.full_like(d, nbits + 1))
    best = torch.argmin(d, dim=1)
    bestd = torch.gather(d, 1, best[:, None])[:, 0]
    return best, valid_a & (bestd <= max_norm_distance * nbits)


def _homography_dlt(src, dst):
    """Four-point homographies by DLT, batched: src / dst [..., 4, 2] ->
    [..., 3, 3], the smallest right singular vector of the [8, 9] system
    (its sign is free: _project divides by w)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    a = torch.stack([r1, r2], dim=-2).reshape(src.shape[:-2] + (8, 9))
    _, _, vt = torch.linalg.svd(a)
    return vt[..., -1, :].reshape(src.shape[:-2] + (3, 3))


def _project(hmat, pts):
    """pts [K, 2] through homographies [..., 3, 3] -> [..., K, 2]."""
    homo = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)
    out = homo @ hmat.transpose(-1, -2)
    w = out[..., 2:3]
    return out[..., :2] / torch.where(torch.abs(w) > 1e-9, w, torch.full_like(w, 1e-9))


def ransac_homography(src, dst, mask, idx, tolerance=3.0):
    """Parallel-hypothesis RANSAC homography inlier filter
    (KinectVehicle.cs:529-553). src / dst [K, 2] matched point pairs with a
    validity mask [K]; idx [iterations, 4] the sample rows of each
    hypothesis. Returns the best hypothesis' inlier mask (the first of
    equal counts), or `mask` when it has fewer than min(4, valid) inliers."""
    hmat = _homography_dlt(src[idx], dst[idx])  # [I, 3, 3]
    err = torch.linalg.norm(_project(hmat, src) - dst[None], dim=-1)  # [I, K]
    inliers = mask[None, :] & (err < tolerance)
    counts = torch.sum(inliers, dim=1)
    best = torch.argmax(counts, dim=0, keepdim=True)  # a tensor index: no host read
    n_valid = torch.clamp(torch.sum(mask), min=1)
    ok = torch.gather(counts, 0, best)[0] >= torch.clamp(n_valid, max=4)
    return torch.where(ok, torch.index_select(inliers, 0, best)[0], mask)


def uniform_draws(generator):
    """draw(mask, iterations) -> [iterations, 4] rows drawn uniformly from the
    valid rows of `mask`, with replacement (from all rows when none is
    valid): what jax.random.categorical draws over logits
    where(mask, 0, -1e9). Stays on the device: no host read."""

    def draw(mask, iterations):
        w = torch.where(torch.any(mask), mask, torch.ones_like(mask)).to(torch.float32)
        cdf = torch.cumsum(w, dim=0)
        u = torch.rand((iterations, 4), generator=generator, device=mask.device) * cdf[-1]
        return torch.clamp(torch.searchsorted(cdf, u, right=True), max=mask.shape[0] - 1)

    return draw


def temporal_filter(xy, desc, valid, prev_xy, prev_desc, prev_valid, draw,
                    max_norm_distance=0.37, tolerance=3.0):
    """Keep the current keypoints that match the previous frame and survive
    the homography consistency check; without previous keypoints everything
    passes (KinectVehicle.cs:505-508). draw(matched mask, ITERATIONS) gives
    RANSAC's sample rows."""
    match, matched = knn_match(desc, valid, prev_desc, prev_valid, max_norm_distance)
    inliers = ransac_homography(xy, prev_xy[match], matched, draw(matched, ITERATIONS), tolerance)
    return torch.where(torch.any(prev_valid), valid & inliers, valid)
