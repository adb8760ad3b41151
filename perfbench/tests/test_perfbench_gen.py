"""Corpus and traffic generators: deterministic by seed, the realized
means the configuration files record, the folded Zipf law."""

import numpy as np
import pytest

from perfbench import gen, plugins
from perfbench.dists import zipf_mod


@pytest.mark.parametrize("seed", [0, 2**31 + 7, -5, 2**70 + 3])
def test_same_seed_same_inputs(seed):
    cfg = plugins.load_json("configs", "fiqa")
    cfg["corpus"]["docs"] = 500
    tr = plugins.load_json("traffic", "online")
    names = gen.token_names(30000)
    a = [gen.streams(seed) for _ in range(2)]
    c1, c2 = gen.corpus(cfg, a[0][0]), gen.corpus(cfg, a[1][0])
    p1 = gen.pool(cfg, tr, a[0][1])
    p2 = gen.pool(cfg, tr, a[1][1])
    p1.tokenize(names)
    p2.tokenize(names)
    assert np.array_equal(c1.ids, c2.ids)
    assert np.array_equal(c1.offsets, c2.offsets)
    assert np.array_equal(p1.texts.ids, p2.texts.ids)
    assert p1.tokens == p2.tokens
    other = gen.corpus(cfg, gen.streams(seed + 1)[0])
    assert not np.array_equal(c1.ids[:1000], other.ids[:1000])


@pytest.mark.parametrize("name,mix", [("fiqa", "bulk"), ("scale1m", "bulk")])
@pytest.mark.parametrize("seed", [0, 1, 2, 987654321])
def test_realized_means_match_the_config_file(name, mix, seed):
    cfg = plugins.load_json("configs", name)
    tr = plugins.load_json("traffic", mix)
    rc, rt, _ = gen.streams(seed)
    lens = gen.dist(cfg["corpus"]["length"])(rc, cfg["corpus"]["docs"])
    sizes = gen.request_sizes(tr, rt)
    qlens = gen.dist(cfg["queries"]["length"])(rt, int(sizes.sum()))
    real = cfg["realized"]
    assert lens.mean() == pytest.approx(real["doc_length_mean"], rel=1e-12)
    assert qlens.mean() == pytest.approx(real["query_length_mean"], rel=1e-12)


def test_fiqa_means_are_the_published_ones():
    cfg = plugins.load_json("configs", "fiqa")
    assert cfg["realized"]["doc_length_mean"] == pytest.approx(132.3, abs=0.1)
    assert cfg["realized"]["query_length_mean"] == pytest.approx(10.8,
                                                                 abs=0.01)


def test_online_requests_are_single_queries_of_one_set_of_lengths():
    cfg = plugins.load_json("configs", "fiqa")
    tr = plugins.load_json("traffic", "online")
    a = gen.pool(cfg, tr, gen.streams(1)[1])
    b = gen.pool(cfg, tr, gen.streams(2)[1])
    assert len(a) == len(b) == tr["pool"]
    assert {a.size(r) for r in range(len(a))} == {1}
    la, lb = a.texts.lengths(), b.texts.lengths()
    assert not np.array_equal(la, lb)
    assert np.array_equal(np.sort(la), np.sort(lb))
    assert la.mean() == pytest.approx(10.8, abs=0.05)


def test_zipf_mod_is_the_upstream_draw_in_law():
    params = {"dist": "zipf_mod", "a": 1.3, "mod": 30000}
    n = 2_000_000
    ours = gen.dist(params)(np.random.default_rng(3), n)
    theirs = np.random.default_rng(4).zipf(1.3, size=n) % 30000
    p = zipf_mod.probabilities(1.3, 30000)
    for x in (ours, theirs):
        emp = np.bincount(x, minlength=30000) / n
        # each of the 30 heaviest ids within 5 standard errors
        se = np.sqrt(p[:30] * (1 - p[:30]) / n)
        assert (np.abs(emp[:30] - p[:30]) < 5 * se).all()
    assert ours.dtype == np.int32 and ours.min() >= 0 and ours.max() < 30000


@pytest.mark.parametrize("fixed", [True, False])
def test_token_lists_name_each_id(fixed):
    rng = np.random.default_rng(0)
    length = ({"dist": "fixed", "n": 7} if fixed else
              {"dist": "lognormal", "mean": 9, "sigma": 0.75, "min": 1,
               "max": 60})
    texts = gen.draw_texts(rng, 301, length,
                           {"dist": "zipf_mod", "a": 1.3, "mod": 50})
    names = gen.token_names(50)
    toks = gen.to_tokens(texts, names)
    assert len(toks) == 301
    for i in (0, 150, 300):
        assert toks[i] == [f"t{t}" for t in texts.row(i)]
