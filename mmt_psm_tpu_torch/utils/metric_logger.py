"""Windowed metric smoothing (the port's copy of
``mmt_psm_tpu/utils/metric_logger.py``, after the reference's
maskrcnn_benchmark/utils/metric_logger.py:8-66)."""

from __future__ import annotations

from collections import defaultdict, deque


class SmoothedValue:
    """Median and mean over a window of the last values, and the mean of all
    of them (metric_logger.py:8-37)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        value = float(value)
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self):
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        return d[n // 2] if n % 2 == 1 else 0.5 * (d[n // 2 - 1] + d[n // 2])

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / self.count if self.count else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {m.median:.4f} ({m.global_avg:.4f})" for name, m in self.meters.items())
