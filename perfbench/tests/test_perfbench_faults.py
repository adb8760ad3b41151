"""The comparison fails what it must: the timed path broken underneath a
run (an answer altered where it is produced, half of each request left
out, one probability moved, every answer's logit moved alike), and the
control, each at a size a test run holds."""

import numpy as np
import pytest

from perfbench import control, run
from tiny import tiny


class Broken:
    """The scorer, with its answers broken on the way out."""

    def __init__(self, scorer, how):
        self.s, self.how = scorer, how
        self.calls = 0

    def _break(self, ans):
        ids, probs = ans[0].copy(), ans[1].copy()
        if self.how == "altered":
            # the best answer of every row replaced by the next document
            ids[:, 0] = (ids[:, 0] + 1) % self.s.num_docs
        elif self.how == "half":
            # the second half of each batch; of one-query requests,
            # every second one
            self.calls += 1
            h = (len(ids) + 1) // 2 if len(ids) > 1 else self.calls % 2
            ids[h:], probs[h:] = -1, 0.0
        elif self.how == "prob":
            probs[:, 0] = np.clip(probs[:, 0] * 1.01, 0, 1)
        elif self.how.startswith("logit"):
            # every answer's logit moved by the same amount, as a wrong
            # beta or base rate moves it
            d = 0.3 if self.how == "logit+" else -0.3
            live = (probs > 0) & (probs < 1)
            z = np.log(probs[live]) - np.log1p(-probs[live]) + d
            probs[live] = 1.0 / (1.0 + np.exp(-z))
        return ids, probs

    def retrieve(self, q, **kw):
        return self._break(self.s.retrieve(q, **kw))

    def retrieve_stream(self, qs, **kw):
        for ans in self.s.retrieve_stream(qs, **kw):
            yield self._break(ans)


@pytest.mark.parametrize("cell", ["fiqa.bulk", "fiqa.online",
                                  "scale1m.bulk"])
@pytest.mark.parametrize("how", ["altered", "half", "prob", "logit+",
                                 "logit-"])
def test_a_broken_path_is_not_correct(cell, how):
    cfg, tr = tiny(cell, int8=cell.startswith("scale1m"))
    res, _ = run.run_cell(cell, 17, 0.5, False, device="cpu", config=cfg,
                          traffic=tr, wrap=lambda s: Broken(s, how))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["fiqa.bulk", "fiqa.online",
                                  "scale1m.bulk"])
def test_the_sound_path_is_correct(cell):
    cfg, tr = tiny(cell, int8=cell.startswith("scale1m"))
    res, _ = run.run_cell(cell, 17, 0.5, False, device="cpu", config=cfg,
                          traffic=tr)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("cell", ["fiqa.bulk", "scale1m.bulk"])
def test_the_control_is_not_correct(cell):
    cfg, tr = tiny(cell, docs=4000, int8=cell.startswith("scale1m"))
    tr["check_rows"] = 512
    res, _ = control.control_run(cell, 23, 0.5, device="cpu", config=cfg,
                                 traffic=tr)
    assert res["correct"] is False, res["checks"]
