"""The one traffic generator: the same seed gives the same traffic, every
seed the same multiset of lengths, and the lengths have the mix's shape."""
import numpy as np

from perfbench import cells, traffic as TR


def test_length_grid_median_and_clip():
    spec = {"median": 48, "sigma": 0.6, "min": 16, "max": 128}
    g = TR.length_grid(spec, 1001)
    assert g.min() >= 16 and g.max() <= 128
    assert abs(np.median(g) - 48) <= 1
    assert (g == 128).sum() > 0          # the lognormal's tail is clipped


def test_serve_requests_repeat_per_seed():
    spec = cells.traffic("decode-c128")
    a = TR.serve_requests(spec, 2**31 + 5, 50304)
    b = TR.serve_requests(spec, 2**31 + 5, 50304)
    c = TR.serve_requests(spec, 7, 50304)
    flat = lambda r: [(j, p.tolist(), g) for j, cl in r for p, g in cl]  # noqa: E731
    assert flat(a) == flat(b)
    assert flat(a) != flat(c)
    seqs = lambda r: {j: [(len(p), g) for p, g in cl] for j, cl in r}  # noqa: E731
    assert seqs(a) == seqs(c)             # each sequence's lengths, every seed
    assert [j for j, _ in a] != [j for j, _ in c]   # submitted in another order
    assert sorted(j for j, _ in a) == list(range(spec["clients"]))
    assert all(0 <= t < 50304 for _, cl in a for p, _ in cl for t in p[:4])


def test_serve_mix_statistics():
    for name, med_p, med_o in (("decode-c128", 48, 128), ("prefill-c128", 256, 32)):
        spec = cells.traffic(name)
        r = TR.serve_requests(spec, 1, 1000)
        p = np.array([len(x) for _, cl in r for x, _ in cl])
        o = np.array([g for _, cl in r for _, g in cl])
        assert abs(np.median(p) - med_p) <= 1 and abs(np.median(o) - med_o) <= 1
        assert p.min() >= spec["prompt"]["min"] and p.max() <= spec["prompt"]["max"]
        assert o.min() >= spec["output"]["min"] and o.max() <= spec["output"]["max"]


def test_client_starts_stagger_over_one_request():
    spec = cells.traffic("decode-c128")
    s = TR.client_start_steps(spec)
    r = TR.mean_request_steps(spec)
    assert s[0] == 0 and max(s) < r and s == sorted(s)


def test_train_batches_repeat_and_pack():
    spec = dict(cells.traffic("train-4k"), pool=2, seq_len=512)
    a = TR.train_batches(spec, 2**31 + 9, 49155)
    b = TR.train_batches(spec, 2**31 + 9, 49155)
    c = TR.train_batches(spec, 3, 49155)
    assert a.shape == (2, 4, 512) and a.dtype == np.int64
    assert (a == b).all() and (a != c).any()
    rows = a.reshape(-1, 512)
    assert len({r.tobytes() for r in rows}) == len(rows)   # rows all differ
    assert ((rows == spec["separator"]).sum(1) >= 1).all()  # documents packed
    assert rows.min() >= 0 and rows.max() < 49155
