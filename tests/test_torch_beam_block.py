"""What the beam kernel's block design (csrc/beam_scan.cu) relies on, checked
over the plain scan's own steps at the shapes that design serves (the
default PHDConfig's B=200 C=8 with 4 words over 48 steps; the smoother's
B=32 C=8 with 1 word over 33), on random and tie-heavy options:

- each candidate's 64-bit key (the order key of its value above the
  inverted flat index b (C+1) + c) is unique, and the keys in descending
  order are the stable descending sort of the values, the plain scan's (and
  lax.top_k's) order;
- the kernel's selection, written out here in numpy as the kernel does it
  (four 8-bit radix passes over the order keys from the top, a pass ending
  the search when its bin is taken whole; then the keys above the found
  prefix and, of those at it, the lowest flat indices; then each kept key's
  rank among the B by counting), keeps the plain scan's B rows in its order;
- for each option, the candidates the used set does not mask are
  non-increasing over the rows (the rows come out of each step sorted, and a
  float32 sum with one delta is monotone), and so are the masked ones.
"""

import numpy as np
import pytest
import torch

from monorfs_tpu_torch.kernel_cases import beam_ties
from monorfs_tpu_torch.slam import association

def _random(seed, p, n, m, c):
    g = torch.Generator().manual_seed(seed)
    ll = torch.randn((p, n, m), generator=g) * 3
    ll = torch.where(torch.rand((p, n, m), generator=g) < 0.7, torch.full_like(ll, association.NEG), ll)
    log_miss = torch.randn((p, n), generator=g) * 0.5 - 1
    n_mask = torch.rand((p, n), generator=g) < 0.8
    m_mask = torch.rand((p, m), generator=g) < 0.8
    base, od, wk, bk, n_words = association.prepare_options(ll, log_miss, -2.5, n_mask, m_mask, c)
    return (base, od, wk, bk), n_words


def _steps(base, od, wk, bk, b, n_words):
    """Each step of the plain scan (association._scan's arithmetic): yields
    (candidate values [P, B, C+1], used mask [P, B, C], kept flat indices
    [P, B], kept scores [P, B])."""
    p, m, c1 = od.shape
    scores = torch.full((p, b), association.NEG, dtype=od.dtype)
    scores[:, 0] = base
    words = torch.zeros((p, b, n_words), dtype=torch.int32)
    in_range = (wk >= 0) & (wk < n_words)
    widx = torch.where(in_range, wk, 0).long()
    bits = torch.where(in_range, bk, 0)
    w_iota = torch.arange(n_words)
    for step in range(m):
        dk = od[:, step]
        uw = torch.gather(words, 2, widx[:, None, step].expand(-1, b, -1))
        used = (uw & bits[:, None, step]) != 0
        opts = torch.cat([dk[:, None, 0:1].expand(-1, b, 1), torch.where(used, association.NEG, dk[:, None, 1:])], 2)
        vals = scores[:, :, None] + opts
        sv, order = torch.sort(vals.reshape(p, b * c1), dim=-1, descending=True, stable=True)
        scores, flat = sv[:, :b], order[:, :b]
        yield vals, used, flat, scores
        src, choice = flat // c1, flat % c1
        pick = torch.clamp(choice - 1, min=0)
        pw = torch.where(choice > 0, torch.gather(wk[:, step], 1, pick), 0)
        pb = torch.where(choice > 0, torch.gather(bk[:, step], 1, pick), 0)
        g = torch.gather(words, 1, src[:, :, None].expand(-1, -1, n_words))
        words = g | torch.where(pw[:, :, None] == w_iota, pb[:, :, None], 0)


def order_key(v):
    """The kernel's order_key: float32 -> uint32, order-preserving, -0 = +0."""
    u = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def keys64(vals):
    """[NC] float32 -> the kernel's 64-bit keys (order key above ~flat)."""
    flat = np.arange(vals.size, dtype=np.uint64)
    return (order_key(vals).astype(np.uint64) << np.uint64(32)) | (~flat & np.uint64(0xFFFFFFFF))


def block_select(hi, b):
    """The block design's selection of one step, as the kernel runs it:
    flat indices of the kept rows in rank order."""
    prefix, mask, need = 0, 0, b
    for sh in (24, 16, 8, 0):
        live = ((hi ^ prefix) & mask) == 0
        hist = np.bincount(255 - ((hi[live] >> sh) & 255), minlength=256)
        above = np.concatenate([[0], np.cumsum(hist)[:-1]])
        binx = int(np.argmax(above + hist >= need))
        prefix |= (255 - binx) << sh
        need -= int(above[binx])
        mask |= 255 << sh
        if hist[binx] == need:
            break
    h = hi & mask
    eq = np.flatnonzero(h == prefix)
    kept = np.concatenate([np.flatnonzero(h > prefix), eq[:need]])
    assert kept.size == b
    key = (hi[kept].astype(np.uint64) << np.uint64(32)) | (~kept.astype(np.uint64) & np.uint64(0xFFFFFFFF))
    rank = (key[None, :] > key[:, None]).sum(1)
    out = np.empty(b, np.int64)
    out[rank] = kept
    return out


CASES = {  # name: (B, C, n_words, M, landmarks)
    "default-B200-C8-W4-M48": (200, 8, 4, 48, 128),
    "smoother-B32-C8-W1-M33": (32, 8, 1, 33, 32),
}


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("case", list(CASES))
def test_block_design_properties(case, kind):
    b, c, n_words, m, n_lm = CASES[case]
    p = 3
    if kind == "random":
        inputs, nw = _random(19, p, n_lm, m, c)
        assert nw == n_words
    else:
        inputs = [torch.from_numpy(x) for x in beam_ties(23, p, m, c, n_words)]
    c1 = c + 1
    ties_seen = 0
    for vals, used, flat, scores in _steps(*inputs, b, n_words):
        for i in range(p):
            v = vals[i].numpy()  # [B, C+1]
            keys = keys64(v.reshape(-1))
            assert np.unique(keys).size == keys.size
            stable = torch.sort(vals[i].reshape(-1), descending=True, stable=True)[1].numpy()
            np.testing.assert_array_equal(np.argsort(keys)[::-1], stable)
            np.testing.assert_array_equal(stable[:b], flat[i].numpy())
            np.testing.assert_array_equal(block_select(order_key(v.reshape(-1)).astype(np.int64), b),
                                          flat[i].numpy())
            masked = np.concatenate([np.zeros((b, 1), bool), used[i].numpy()], 1)
            for o in range(c1):
                for sel in (~masked[:, o], masked[:, o]):
                    col = v[sel, o]
                    assert np.all(col[1:] <= col[:-1])
            kept = v.reshape(-1)[flat[i].numpy()]
            ties_seen += int((kept[1:] == kept[:-1]).sum())
    # the steps are the plain scan's: the same final scores
    assert torch.equal(scores, association.beam_scan(*inputs, b, n_words))
    if kind == "ties":  # the case is what it claims: equal values among the kept rows
        assert ties_seen > p * m * b // 8
