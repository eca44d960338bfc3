"""engine.plan_ms.get: the mean ``plan.compile`` span of a get batch
(the engine front: ``engine/engine.py``, ``engine/plan.py``), in ms."""

from perfbench.window import mean_ms


def read(w):
    return mean_ms([s["t1"] - s["t0"] for s in w.of_kind("plan.compile",
                                                          "get")])
