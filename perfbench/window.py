"""What a measured window records, and the end-to-end arithmetic on
it: a rate over all the work and all the seconds of the window, a tail
over all requests completed in it."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    t0: float          # host clock at the window's start
    seconds: float
    pool_index: list = field(default_factory=list)
    sizes: list = field(default_factory=list)
    hand: list = field(default_factory=list)     # handed to the entry
    done: list = field(default_factory=list)     # answer on the host
    answers: list = field(default_factory=list)  # (ids, probs) per request

    def handed(self, r: int, size: int, t: float) -> int:
        self.pool_index.append(r)
        self.sizes.append(size)
        self.hand.append(t)
        self.done.append(None)
        self.answers.append(None)
        return len(self.hand) - 1

    def finished(self, i: int, t: float, answer) -> None:
        self.done[i] = t
        self.answers[i] = answer

    @property
    def end(self) -> float:
        return self.t0 + self.seconds

    def attempted(self) -> int:
        """Requests handed to the entry inside the window."""
        return sum(1 for t in self.hand if t < self.end)

    def failed(self) -> int:
        """Requests handed that never came back."""
        return sum(1 for d in self.done if d is None)

    def completed(self) -> list:
        """Requests whose answer reached the host inside the window."""
        return [i for i, d in enumerate(self.done)
                if d is not None and d <= self.end]

    def qps(self) -> float:
        return sum(self.sizes[i] for i in self.completed()) / self.seconds

    def completed_per(self, step: float) -> list:
        """Queries completed in each ``step`` seconds of the window (the
        last slot may be shorter): a slow start or a stall shows here."""
        slots = [0] * max(1, math.ceil(self.seconds / step))
        for i in self.completed():
            j = int((self.done[i] - self.t0) // step)
            slots[min(max(j, 0), len(slots) - 1)] += self.sizes[i]
        return slots

    def latencies_ms(self) -> np.ndarray:
        return np.array([(self.done[i] - self.hand[i]) * 1e3
                         for i in self.completed()])

    def latency_p95_ms(self) -> float:
        return float(np.percentile(self.latencies_ms(), 95))
