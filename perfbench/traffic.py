"""The benchmark's one traffic generator.

A configuration file fixes the data (the preloaded stream: how many
keys, in batches of how many puts, each followed by how many range
deletes of what length) and a traffic file fixes the requests of the
measured window as one round of request entries::

    {"round": [{"kind": "get", "count": 9, "keys": 8192,
                "present_share": 0.5},
               {"kind": "write", "count": 1, "puts": 7373,
                "range_deletes": 819, "range_len": 256}]}

Entry kinds and their parameters:

  get    ``keys`` lookups, ``present_share`` of them drawn uniformly
         from the preloaded keys and the rest uniformly over the key
         universe (mostly absent);
  write  ``puts`` YCSB updates (keys drawn uniformly from the preloaded
         keys), then ``range_deletes`` range deletes of ``range_len``
         at uniform starts, in one batch;
  scan   ``inserts`` puts of new keys uniform over the universe, then
         ``scans`` range scans in the same batch (so the scans see the
         inserts), each starting at a preloaded key drawn by YCSB's
         Zipfian request distribution (``zipf_theta``) and
         ``records`` = [lo, hi] records long, a record being
         ``universe / preload_keys`` key units wide.

Request ``i`` belongs to round ``i // round_len``; each round takes the
round's requests in its own seeded order, so every round holds the
mix's shares.  Set-up warms up with ``WARMUP_EACH`` requests of every
entry of the round.  Every request is drawn from its own stream of the seed,
so the same seed gives the same request ``i`` however many requests a
run completes.  Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MASK64 = (1 << 64) - 1
WARMUP_EACH = 2
# Stream ids under one seed: each part of the traffic draws its own.
_PRELOAD, _ORDER, _REQUEST, _TAIL, _WARMUP = range(5)


@dataclass
class Request:
    """One batch a client hands the engine; unused columns are None."""

    kind: str                       # "get" | "write" | "scan"
    index: int                      # position in the run (warm-up < 0)
    keys: np.ndarray | None = None  # gets
    put_keys: np.ndarray | None = None
    put_vals: np.ndarray | None = None
    lo: np.ndarray | None = None    # range deletes (write) or scans
    hi: np.ndarray | None = None

    @property
    def ops(self) -> int:
        """Operations the request carries: a key looked up, a put, a
        range delete or a scan is one."""
        if self.kind == "get":
            return len(self.keys)
        puts = 0 if self.put_keys is None else len(self.put_keys)
        return puts + len(self.lo)


class ZipfKeys:
    """Zipfian item ranks over a bounded universe by inverse-CDF
    sampling (a copy of ``repro_torch.baselines.workload.zipf_keys``,
    with its CDF built once)."""

    def __init__(self, universe: int, s: float = 0.99,
                 n_distinct: int = 1 << 16):
        ranks = np.arange(1, n_distinct + 1, dtype=np.float64)
        cdf = np.cumsum(ranks ** (-s))
        self.cdf = cdf / cdf[-1]
        self.universe = int(universe)

    def __call__(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = np.searchsorted(self.cdf, rng.random(n))
        # Spread the hot ranks over the universe deterministically.
        spread = (np.uint64(0x9E3779B97F4A7C15) *
                  (idx.astype(np.uint64) + np.uint64(1)))
        return spread % np.uint64(self.universe)


def put_values(keys: np.ndarray, index: int) -> np.ndarray:
    """Values of request ``index``'s puts: key + 1 in the preload
    (index -1), and for every other request a value no other request
    writes to that key, so a read of an older version shows.  Keys are
    below 2^29 and values stay below 2^63."""
    tag = index + 1 if index >= -1 else (1 << 30) - index
    return keys + np.uint64(1) + np.uint64(tag << 29)


class Traffic:
    """The preload, warm-up and window requests of one cell and seed."""

    def __init__(self, config: dict, mix: dict, seed: int):
        self.config = config
        self.mix = mix
        self.seed = int(seed) & MASK64
        self.universe = int(config["key_universe"])
        self.range_len = int(config["range_delete_len"])
        self.round = [e for e in mix["round"] for _ in range(e["count"])]
        self.keys, self.preload_lo = self._preload_stream()
        self._zipf = None

    def rng(self, *stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *stream])

    # ------------------------------------------------------------ preload
    def _preload_stream(self):
        """Put keys (value = key + 1) uniform over the universe, and for
        each put batch its range deletes' low bounds (as
        ``chip_smoke.make_stream``)."""
        c = self.config
        n, batch = int(c["preload_keys"]), int(c["preload_batch"])
        rng = self.rng(_PRELOAD)
        keys = rng.integers(0, self.universe, n, dtype=np.uint64)
        los = rng.integers(0, self.universe - self.range_len,
                           (-(-n // batch), int(c["preload_range_deletes"])),
                           dtype=np.uint64)
        return keys, los

    def preload(self):
        """(put keys, put values, range-delete lows) per preload batch."""
        batch = int(self.config["preload_batch"])
        for b, lo in enumerate(self.preload_lo):
            k = self.keys[b * batch:(b + 1) * batch]
            yield k, put_values(k, -1), lo

    def tail_lo(self, t: int) -> np.ndarray:
        """Low bounds of the t-th batch of tail range deletes."""
        return self.rng(_TAIL, t).integers(
            0, self.universe - self.range_len,
            int(self.config["tail_range_deletes"]), dtype=np.uint64)

    # ----------------------------------------------------------- requests
    def request(self, i: int) -> Request:
        """Request ``i`` of the window."""
        r, slot = divmod(i, len(self.round))
        order = self.rng(_ORDER, r).permutation(len(self.round))
        return self._draw(self.round[int(order[slot])],
                          self.rng(_REQUEST, i), i)

    def warmup(self) -> list[Request]:
        """``WARMUP_EACH`` requests of every entry of the round, drawn
        from streams of their own, with negative indices."""
        kinds = list(self.mix["round"])
        out = []
        for j in range(WARMUP_EACH * len(kinds)):
            e = kinds[j % len(kinds)]
            out.append(self._draw(e, self.rng(_WARMUP, j), -2 - j))
        return out

    def _draw(self, e: dict, rng: np.random.Generator, i: int) -> Request:
        kind = e["kind"]
        if kind == "get":
            n = int(e["keys"])
            m = int(round(n * float(e["present_share"])))
            present = self.keys[rng.integers(0, len(self.keys), m)]
            absent = rng.integers(0, self.universe, n - m, dtype=np.uint64)
            keys = rng.permutation(np.concatenate([present, absent]))
            return Request("get", i, keys=keys)
        if kind == "write":
            k = self.keys[rng.integers(0, len(self.keys), int(e["puts"]))]
            length = int(e.get("range_len", self.range_len))
            lo = rng.integers(0, self.universe - length,
                              int(e.get("range_deletes", 0)),
                              dtype=np.uint64)
            return Request("write", i, put_keys=k, put_vals=put_values(k, i),
                           lo=lo, hi=lo + np.uint64(length))
        if kind == "scan":
            n = int(e["scans"])
            if self._zipf is None:
                self._zipf = ZipfKeys(len(self.keys), float(e["zipf_theta"]),
                                      n_distinct=len(self.keys))
            lo = self.keys[self._zipf(rng, n).astype(np.int64)]
            a, b = e["records"]
            width = self.universe / int(self.config["preload_keys"])
            records = rng.integers(int(a), int(b) + 1, n)
            span = np.ceil(records * width).astype(np.uint64)
            hi = np.minimum(lo + span, np.uint64(self.universe))
            k = rng.integers(0, self.universe, int(e.get("inserts", 0)),
                             dtype=np.uint64)
            return Request("scan", i, put_keys=k, put_vals=put_values(k, i),
                           lo=lo, hi=hi)
        raise ValueError(f"request kind {kind!r}")


def round_shares(mix: dict) -> dict:
    """Operations of each kind in one round (puts and range deletes
    apart): the shares the mix keeps."""
    out: dict = {}
    for e in mix["round"]:
        c = int(e["count"])
        if e["kind"] == "get":
            parts = {"get": int(e["keys"])}
        elif e["kind"] == "write":
            parts = {"put": int(e["puts"]),
                     "range_delete": int(e.get("range_deletes", 0))}
        else:
            parts = {"scan": int(e["scans"]),
                     "put": int(e.get("inserts", 0))}
        for k, v in parts.items():
            out[k] = out.get(k, 0) + c * v
    return out

