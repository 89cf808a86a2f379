"""The lambdarank kernel's schedule (``ops/lambdarank.py``), on the CPU.

The kernel (``csrc/lambdarank.cu``) runs on the card only; these tests
hold the host half of its design: every unordered pair of unequal labels
in exactly one warp tile, the label-grouped permutation, the long
queries' partial-sum addressing, and the kernel's arithmetic summed tile
by tile in the schedule's order against ``lambdarank_grad_plain`` at the
chip check's tolerance (1e-5 x the document's sum of |lam| or |hes| +
1e-7).  ``lambdarank_grad`` on CPU tensors is the plain version and
launches nothing.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops.lambdarank import (ITEM_DOCS, MASKED_MAX,
                                               PAIR_TILE, PREFIX, TILE,
                                               WARP_BUNDLE, WARP_QUERY_MAX,
                                               WHOLE,
                                               default_label_gain,
                                               lambdarank_grad,
                                               lambdarank_grad_plain,
                                               lambdarank_schedule,
                                               lambdarank_tables,
                                               schedule_bytes)

# lengths at the schedule's boundaries: one masked tile (1, 2, MASKED_MAX),
# a warp's rectangles (MASKED_MAX + 1 .. WARP_QUERY_MAX), a block's (to
# ITEM_DOCS), and long queries cut into a prefix and tiles
SIZES = [1, 2, MASKED_MAX - 1, MASKED_MAX, MASKED_MAX + 1, 7, WARP_QUERY_MAX,
         WARP_QUERY_MAX + 1, ITEM_DOCS, ITEM_DOCS + 1, 700, 1300]


def _case(rng, sizes, shares=(0.51, 0.33, 0.12, 0.03, 0.01)):
    n = int(sum(sizes))
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    label = rng.choice(len(shares), n, p=shares).astype(np.int32)
    score = rng.standard_normal(n).astype(np.float32)
    return bounds, label, score


def _queries(bounds):
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def schedule_tiles(sched):
    """The warp tiles of ``sched`` in the kernel's order
    (``csrc/lambdarank.cu``: ``warp_bundle``, ``block_item``'s step 5):
    ``(item, query, high slots, low slots, masked)``, slots in the query's
    grouped order.  A masked tile (a query of at most ``MASKED_MAX``
    documents) pairs every slot with every slot and keeps the pairs whose
    high label is the greater; any other tile pairs each of its high slots
    with each of its low slots."""
    items = sched.items.numpy()
    wq = sched.warp_queries.numpy()
    qgroup, gstarts = sched.qgroup.numpy(), sched.gstarts.numpy()

    def rects(q, e):
        gs = gstarts[qgroup[q]:qgroup[q + 1]].tolist()
        return [(gs[g], gs[g + 1], 0, gs[g])
                for g in range(1, len(gs) - 1) if gs[g] < e]

    def cut(i, q, rect_list):
        for lo0, lo1, hi0, hi1 in rect_list:
            for l0 in range(lo0, lo1, 32):
                for h0 in range(hi0, hi1, 32):
                    yield (i, q, np.arange(h0, min(h0 + 32, hi1)),
                           np.arange(l0, min(l0 + 32, lo1)), False)

    for i, (kind, q, a0, a1, c0, c1, _, _) in enumerate(items.tolist()):
        if kind != WARP_BUNDLE:
            yield from cut(i, q, [(c0, c1, a0, a1)] if kind == PAIR_TILE
                           else rects(q, a1))
            continue
        for qq in wq[a0:a0 + a1].tolist():
            m = int(gstarts[qgroup[qq + 1] - 1])
            if m <= MASKED_MAX:
                yield i, qq, np.arange(m), np.arange(m), True
            else:
                yield from cut(i, qq, rects(qq, m))


def test_schedule_groups_labels_within_each_query():
    rng = np.random.default_rng(1)
    bounds, label, _ = _case(rng, SIZES)
    sched = lambdarank_schedule(label, bounds, default_label_gain())
    perm = sched.perm.numpy()
    gain = sched.gain.numpy()
    qgroup, gstarts = sched.qgroup.numpy(), sched.gstarts.numpy()
    assert sorted(perm.tolist()) == list(range(len(label)))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    np.testing.assert_array_equal(perm[inv], np.arange(len(perm)))
    gains = np.asarray(default_label_gain(), np.float32)
    for q, (a, b) in enumerate(_queries(bounds)):
        rows = perm[a:b]
        assert ((rows >= a) & (rows < b)).all()
        lab = label[rows]
        assert (np.diff(lab) <= 0).all()            # highest label first
        for y in np.unique(lab):                    # ties in row order
            assert (np.diff(rows[lab == y]) > 0).all()
        np.testing.assert_array_equal(gain[a:b], gains[lab])
        gs = gstarts[qgroup[q]:qgroup[q + 1]]
        assert gs[0] == 0 and gs[-1] == b - a
        assert len(gs) - 1 == len(np.unique(lab))
        for g0, g1 in zip(gs[:-1], gs[1:]):
            assert (lab[g0:g1] == lab[g0]).all()


def test_schedule_covers_each_unequal_pair_once():
    rng = np.random.default_rng(2)
    sizes = SIZES + [3000]
    bounds, label, _ = _case(rng, sizes)
    sched = lambdarank_schedule(label, bounds, default_label_gain())
    perm = sched.perm.numpy()
    counts = [np.zeros((b - a, b - a), np.int32)
              for a, b in _queries(bounds)]
    for _, q, hi, lo, masked in schedule_tiles(sched):
        a = bounds[q]
        y = label[perm[a:bounds[q + 1]]]
        if masked:
            keep = y[hi][:, None] > y[lo][None, :]
            np.add.at(counts[q], (np.broadcast_to(hi[:, None], keep.shape)
                                  [keep], np.broadcast_to(
                                      lo[None, :], keep.shape)[keep]), 1)
        else:
            assert len(hi) and len(lo) and len(hi) <= 32 and len(lo) <= 32
            # a plain tile holds only pairs of unequal labels, high first
            assert (y[hi][:, None] > y[lo][None, :]).all()
            counts[q][np.ix_(hi, lo)] += 1
    for q, (a, b) in enumerate(_queries(bounds)):
        y = label[perm[a:b]]
        np.testing.assert_array_equal(
            counts[q], (y[:, None] > y[None, :]).astype(np.int32))
    # the work items: block items within the kernel's shared memory, long
    # queries cut as the kernel's final sum addresses them
    items = sched.items.numpy()
    docs = np.where(items[:, 0] == PAIR_TILE,
                    items[:, 3] - items[:, 2] + items[:, 5] - items[:, 4],
                    items[:, 3])
    block = items[:, 0] != WARP_BUNDLE
    assert docs[block].max() == sched.smem_docs <= ITEM_DOCS
    assert (np.diff(items[:, 7]) <= 0).all()        # heaviest first
    kinds = {int(k): int((items[:, 0] == k).sum())
             for k in (WARP_BUNDLE, WHOLE, PREFIX, PAIR_TILE)}
    assert kinds[WARP_BUNDLE] == 1 and kinds[PREFIX] == 4
    assert sorted(sched.warp_queries.tolist()) == [0, 1, 2, 3, 4, 5, 6]
    assert kinds[WHOLE] == 2


def test_schedule_bytes_are_its_tensors():
    """The memory model's term (``schedule_bytes``, from the label groups
    alone) is the schedule's tensors to the byte."""
    rng = np.random.default_rng(6)
    bounds, label, _ = _case(rng, SIZES + [3000])
    sched = lambdarank_schedule(label, bounds, default_label_gain())
    assert schedule_bytes(label, bounds) == sum(
        t.numel() * t.element_size() for t in sched.tensors())


def _final_sum_reads(sched, q, n):
    """The (ordinal, slot) partial sums the kernel's last block adds for
    each document of split query q, in its order (csrc/lambdarank.cu,
    block_item step 7)."""
    base, _, e, _ = sched.split_info[sched.qsplit[q]].tolist()
    gs = sched.gstarts[sched.qgroup[q]:sched.qgroup[q + 1]].tolist()
    out = []
    for k in range(n):
        reads = [(0, k)] if k < e else []
        ord_ = 1
        for g in range(1, len(gs) - 1):
            st, en = gs[g], gs[g + 1]
            if en <= e:
                continue
            nlt, nht = -(-(en - st) // TILE), -(-st // TILE)
            if st <= k < en:
                lt = (k - st) // TILE
                reads += [(ord_ + lt * nht + ht,
                           min(TILE, st - ht * TILE) + k - st - lt * TILE)
                          for ht in range(nht)]
            elif k < st:
                ht = k // TILE
                reads += [(ord_ + lt * nht + ht, k - ht * TILE)
                          for lt in range(nlt)]
            ord_ += nlt * nht
        out.append(reads)
    return out


def test_long_queries_partial_sums_are_addressed_in_order():
    rng = np.random.default_rng(3)
    sizes = [ITEM_DOCS + 1, 1300, 3000]
    bounds, label, _ = _case(rng, sizes)
    # one long query with a single label group: a prefix item alone
    label[bounds[0]:bounds[1]] = 2
    sched = lambdarank_schedule(label, bounds, default_label_gain())
    items = sched.items.numpy()
    for q, (a, b) in enumerate(_queries(bounds)):
        own = items[items[:, 1] == q]
        base, n_items, e, _ = sched.split_info[sched.qsplit[q]].tolist()
        assert len(own) == n_items
        assert sorted(own[:, 6].tolist()) == list(range(n_items))
        # each item's slots, by ordinal: the documents it writes
        holds = {}
        for kind, _, a0, a1, c0, c1, o, _ in own.tolist():
            slots = (list(range(a0, a1)) + list(range(c0, c1))
                     if kind == PAIR_TILE else list(range(a1)))
            assert kind in (PREFIX, PAIR_TILE) and (kind == PREFIX) == (o == 0)
            holds[o] = slots
        expect = [[] for _ in range(b - a)]
        for o in sorted(holds):
            for x, k in enumerate(holds[o]):
                expect[k].append((o, x))
        assert _final_sum_reads(sched, q, b - a) == expect


def _tiled(score, label, bounds, sched, inv, gains, disc, sigma, weight):
    """The kernel's arithmetic in float32, tile by tile in the schedule's
    order: lam' = t r q and hes' = lam' (1 - q) summed, then -2 inv and
    8 inv (times 0.01 in a degenerate query) and the weight."""
    perm = sched.perm.numpy()
    n = len(score)
    G, H = np.zeros(n, np.float32), np.zeros(n, np.float32)
    slot_d = np.zeros(n, np.float32)
    mult = np.zeros(len(bounds) - 1, np.float32)
    for q, (a, b) in enumerate(_queries(bounds)):
        rows = perm[a:b]
        s = score[rows]
        key = np.lexsort((rows - a, -s.astype(np.float64)))
        rank = np.empty(b - a, np.int64)
        rank[key] = np.arange(b - a)
        slot_d[a:b] = disc[rank]
        degen = b > a and s.max() == s.min()
        mult[q] = inv[q] * (np.float32(0.01) if degen else np.float32(1))
    k2 = np.float32(2.0 * sigma)
    f32 = np.float32
    for _, q, hi, lo, masked in schedule_tiles(sched):
        a = bounds[q]
        ih, il = a + hi, a + lo
        sh, sl = score[perm[ih]][:, None], score[perm[il]][None, :]
        ds = sh - sl
        r = f32(1) / (np.abs(ds) + f32(0.01))
        with np.errstate(over="ignore"):
            e = np.exp(k2 * ds)
        qq = f32(1) / (f32(1) + e)
        t = ((gains[label[perm[ih]]][:, None] - gains[label[perm[il]]][None])
             * np.abs(slot_d[ih][:, None] - slot_d[il][None, :]))
        if masked:
            t = np.where(label[perm[ih]][:, None] > label[perm[il]][None],
                         t, f32(0))
        lam = t * r * qq
        hq = lam - lam * qq
        G[ih] += lam.sum(1)
        H[ih] += hq.sum(1)
        G[il] -= lam.sum(0)
        H[il] += hq.sum(0)
    qid = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    m = mult[qid]
    g, h = np.empty(n, np.float32), np.empty(n, np.float32)
    g[perm] = f32(-2) * m * G
    h[perm] = f32(8) * m * H
    if weight is not None:
        g, h = g * weight, h * weight
    return g, h


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_tile_sums_match_plain(weighted, sigma):
    rng = np.random.default_rng(4)
    sizes = SIZES + [40, 50, 60, 45, 300]
    bounds, label, score = _case(rng, sizes)
    b = bounds
    score[b[4]:b[5]] = 0.375                          # degenerate: a warp's,
    score[b[5]:b[6]] = -1.25                          # a masked tile's,
    score[b[16]:b[17]] = 2.5                          # a block's
    label[b[12]:b[13]] = 0                            # all-zero labels
    label[b[13]:b[14]] = 1                            # one label group
    score[b[14]:b[15]] = np.round(score[b[14]:b[15]] * 2) / 2   # ties
    score[b[10]:b[11]] = np.round(score[b[10]:b[11]])  # ties across groups
    weight = (rng.uniform(0.5, 2.0, len(label)).astype(np.float32)
              if weighted else None)
    inv, gains, disc = lambdarank_tables(label, bounds, None, 20)
    sched = lambdarank_schedule(label, bounds, gains)
    g, h = _tiled(score, label, bounds, sched, inv, gains, disc, sigma,
                  weight)
    pg, ph, la, ha = (t.numpy() for t in lambdarank_grad_plain(
        torch.from_numpy(score), torch.from_numpy(label), bounds,
        torch.from_numpy(inv), torch.from_numpy(gains),
        torch.from_numpy(disc), sigma,
        None if weight is None else torch.from_numpy(weight),
        abs_sums=True))
    w = 1.0 if weight is None else weight
    np.testing.assert_array_less(np.abs(g - pg), 1e-5 * la * w + 1e-7)
    np.testing.assert_array_less(np.abs(h - ph), 1e-5 * ha * w + 1e-7)
    assert np.abs(pg).max() > 1e-3
    assert not g[b[12]:b[14]].any() and g[0] == 0


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    bounds, label, score = _case(rng, [3, 40, 1, 300])
    inv, gains, disc = lambdarank_tables(label, bounds, None, 20)
    args = (torch.from_numpy(score), torch.from_numpy(label),
            torch.from_numpy(bounds.astype(np.int32)), torch.from_numpy(inv),
            torch.from_numpy(gains), torch.from_numpy(disc), 1.0)
    sched = lambdarank_schedule(label, bounds, gains)
    before = lambdarank_grad.launches
    g, h = lambdarank_grad(*args, max_len=300, schedule=sched)
    pg, ph = lambdarank_grad_plain(*args)
    torch.testing.assert_close(g, pg, rtol=0, atol=0)
    torch.testing.assert_close(h, ph, rtol=0, atol=0)
    assert lambdarank_grad.launches == before
