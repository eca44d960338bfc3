"""Straggler detection: per-host step-time anomaly tracking.

At multi-pod scale a single slow host gates every synchronous collective.
The detector keeps an EMA + variance of per-host step durations and flags
hosts whose latest step exceeds mean + k*sigma of the fleet (and a
relative floor).  The train loop consumes flags to trigger mitigation
(re-replication / hot-spare swap in a real deployment; here: logged events
+ a mitigation callback hook, unit-tested with a simulated clock).
A copy of ``repro.runtime.straggler``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StragglerConfig:
    ema_alpha: float = 0.2
    z_threshold: float = 3.0
    rel_threshold: float = 1.5  # also require 1.5x fleet mean
    min_samples: int = 5


@dataclass
class StragglerDetector:
    n_hosts: int
    config: StragglerConfig = field(default_factory=StragglerConfig)

    def __post_init__(self):
        self.ema = [0.0] * self.n_hosts
        self.var = [0.0] * self.n_hosts
        self.samples = 0
        self.events: list[dict] = []

    def observe(self, step: int, durations: list[float]) -> list[int]:
        """durations[i]: step wall time reported by host i.  Returns the
        list of flagged host ids."""
        assert len(durations) == self.n_hosts
        a = self.config.ema_alpha
        for i, d in enumerate(durations):
            if self.samples == 0:
                self.ema[i] = d
                self.var[i] = 0.0
            else:
                delta = d - self.ema[i]
                self.ema[i] += a * delta
                self.var[i] = (1 - a) * (self.var[i] + a * delta * delta)
        self.samples += 1
        if self.samples < self.config.min_samples:
            return []
        fleet_mean = sum(self.ema) / self.n_hosts
        fleet_var = sum((e - fleet_mean) ** 2
                        for e in self.ema) / self.n_hosts
        sigma = max(fleet_var ** 0.5, 1e-9)
        flagged = []
        for i, d in enumerate(durations):
            z = (d - fleet_mean) / sigma
            if z > self.config.z_threshold and \
                    d > self.config.rel_threshold * fleet_mean:
                flagged.append(i)
                self.events.append({"step": step, "host": i,
                                    "duration": d, "z": z,
                                    "fleet_mean": fleet_mean})
        return flagged
