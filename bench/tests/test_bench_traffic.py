"""The traffic generators: a seed gives the same schedule every time,
another seed another order of the same sizes (so every seed asks the
same work of the card), and other token ids."""
import numpy as np
import pytest

from bench.harness import BENCH, load_json
from bench.traffic import closed_loop, train_steps

SEEDS = (2**31 + 5, 2**33 + 1)


def _closed(seed):
    p = load_json(BENCH / "cells" / "qwen14b-decode-long.json")
    t = closed_loop.Traffic(p["traffic_params"], seed, 152064)
    firsts = [t.request(c, first=True) for c in range(128)]
    rest = [t.request(c % 128) for c in range(256)]
    return firsts + rest


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_loop_repeats_for_a_seed(seed):
    a, b = _closed(seed), _closed(seed)
    assert [(r, len(p), o) for r, p, o in a] == [(r, len(p), o)
                                                 for r, p, o in b]
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def test_closed_loop_differs_across_seeds_in_order_only():
    a, b = _closed(SEEDS[0]), _closed(SEEDS[1])
    assert [len(p) for _, p, _ in a] != [len(p) for _, p, _ in b]
    assert not np.array_equal(a[200][1][:16], b[200][1][:16])
    ta = closed_loop.Traffic(load_json(BENCH / "cells" /
                                       "qwen14b-decode-long.json")
                             ["traffic_params"], SEEDS[0], 10)
    tb = closed_loop.Traffic(load_json(BENCH / "cells" /
                                       "qwen14b-decode-long.json")
                             ["traffic_params"], SEEDS[1], 10)
    assert sorted(ta.first_frac) == sorted(tb.first_frac)
    # every block of 128 requests holds the same sizes whatever the seed
    for k in (0, 1, 2):
        blk = [sorted((len(p), o) for _, p, o in r[128 * k:128 * (k + 1)])
               for r in (a, b)]
        if k:
            assert blk[0] == blk[1]


def test_closed_loop_sizes_within_the_mix():
    p = load_json(BENCH / "cells" / "qwen14b-decode-long.json")
    lo, hi = p["traffic_params"]["prompt_len"]
    olo, ohi = p["traffic_params"]["output_len"]
    reqs = _closed(SEEDS[0])
    assert all(lo <= len(pr) <= hi for _, pr, _ in reqs)
    assert all(olo <= o <= ohi for _, _, o in reqs[128:])
    assert all(1 <= o <= ohi for _, _, o in reqs[:128])
    assert all(len(pr) + o <= p["engine"]["max_len"] for _, pr, o in reqs)


def test_closed_loop_every_seed_asks_the_same_work():
    """The seed draws token ids and which client holds which first
    request; the sizes under way and the sizes that follow, in order,
    are the mix's own."""
    a, b = _closed(SEEDS[0]), _closed(SEEDS[1])
    assert sorted((len(p), o) for _, p, o in a[:128]) == \
        sorted((len(p), o) for _, p, o in b[:128])
    assert [(len(p), o) for _, p, o in a[128:]] == \
        [(len(p), o) for _, p, o in b[128:]]


def test_closed_loop_fill_is_length_biased():
    """The requests under way at set-up are drawn as a running loop holds
    them: by length, so the lanes finish at the loop's steady rate, not
    in a rush of short requests."""
    p = load_json(BENCH / "cells" / "qwen14b-decode-long.json")
    t = closed_loop.Traffic(p["traffic_params"], SEEDS[0], 10)
    rest = t.block[:, 1]
    firsts = np.array([t.request(c, first=True)[2] for c in range(128)])
    rate = len(rest) / rest.mean()          # completions a step, steady
    for steps in (16, 32, 64):
        assert abs((firsts <= steps).sum() - rate * steps) <= 0.2 * \
            rate * steps + 3


def test_closed_loop_medians_are_the_sources():
    """The mix's lengths have the medians of the public trace the cell
    file names (within 1%)."""
    p = load_json(BENCH / "cells" / "qwen14b-decode-long.json")
    src = p["mix_source"]
    t = closed_loop.Traffic(p["traffic_params"], SEEDS[0], 10)
    prompts, outs = t.block[:, 0], t.block[:, 1]
    assert abs(np.median(prompts) / src["median_prompt"] - 1) <= 0.01
    assert abs(np.median(outs) / src["median_output"] - 1) <= 0.01
    # a heavy tail: the mean above the median
    assert prompts.mean() > np.median(prompts)
    assert outs.mean() > np.median(outs)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat_and_rows_differ(seed):
    import torch
    p = load_json(BENCH / "cells" / "falcon7b-train-2k.json")
    t = train_steps.Traffic(p["traffic_params"], seed, 65024)
    a, b = t.batch(3, "cpu"), t.batch(3, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    rows = torch.cat([t.batch(i, "cpu")["tokens"] for i in range(3)])
    assert len({tuple(r[:32].tolist()) for r in rows}) == rows.shape[0]
    other = train_steps.Traffic(p["traffic_params"], seed + 1, 65024)
    assert not torch.equal(other.batch(3, "cpu")["tokens"], a["tokens"])
