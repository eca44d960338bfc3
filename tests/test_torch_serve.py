"""The port's serving loop and session registry against the JAX package.

``ServeLoop.run`` (4 sessions, 8-token prompts, 12 steps) over the same
(carried) parameters gives the JAX loop's tokens, and its registry —
the port's ``Engine`` on the CPU — the same lookups and simulated I/O
reads.  The CLI serves a smoke config on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke
from repro.models import Transformer as JTransformer
from repro.runtime import ServeLoop as JServeLoop
from repro.runtime import SessionRegistry as JSessionRegistry
from repro_torch.carry import load_jax_params
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import smoke as tsmoke
from repro_torch.launch import serve
from repro_torch.models import Transformer
from repro_torch.runtime import ServeLoop, SessionRegistry

torch.set_num_threads(1)

BATCH, PROMPT, STEPS = 4, 8, 12


def registry(cls, **kw):
    reg = cls(strategy="gloran", **kw)
    for s in range(100, 100 + BATCH):
        reg.register(s, np.arange(8), np.arange(8) + s)
    return reg


@pytest.mark.parametrize("arch", ["zamba2-7b", "h2o-danube-3-4b"])
def test_serve_loop_matches_jax(arch):
    sessions = np.arange(BATCH, dtype=np.uint64) + 100
    prompts = np.random.default_rng(2).integers(
        0, 256, (BATCH, PROMPT)).astype(np.int32)
    jloop = JServeLoop(JTransformer(smoke(get_config(arch))), batch=BATCH,
                       max_len=64, registry=registry(JSessionRegistry))
    want = jloop.run(prompts, steps=STEPS, session_ids=sessions)

    model = Transformer(tsmoke(tget_config(arch)), device="cpu")
    loop = ServeLoop(model, batch=BATCH, max_len=64,
                     registry=registry(SessionRegistry, device="cpu"))
    load_jax_params(model, jax.tree.map(np.asarray, jloop.params))
    got = loop.run(prompts, steps=STEPS, session_ids=sessions)
    assert got.shape == (BATCH, STEPS)
    np.testing.assert_array_equal(got, want)
    assert loop.stats.tokens_generated == jloop.stats.tokens_generated
    assert loop.stats.registry_lookups == jloop.stats.registry_lookups \
        == BATCH * STEPS
    assert loop.stats.registry_io_reads == jloop.stats.registry_io_reads


def test_registry_matches_jax_under_range_expiry():
    regs = [registry(JSessionRegistry), registry(SessionRegistry,
                                                 device="cpu")]
    rng = np.random.default_rng(4)
    for reg in regs:
        for sid in range(2000):
            reg.register(sid, np.arange(4), np.arange(4) + sid)
        for sid in range(0, 1600, 80):
            reg.expire_range(sid, sid + 40)
        reg.expire_session(1990)
        reg.expire_spans([(1700, 1710), (1800, 1805)])
        reg.flush()
    sids = rng.integers(0, 2000, 500).astype(np.uint64)
    pages = rng.integers(0, 4, 500).astype(np.uint64)
    (jf, jv), (f, v) = (reg.lookup(sids, pages) for reg in regs)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(v[f], jv[jf])
    assert regs[0].io_reads == regs[1].io_reads
    pending = regs[1].lookup_submit(sids, pages)
    f2, v2 = pending.get_results()
    np.testing.assert_array_equal(f2, f)
    # Live pages come from engine range scans, as in the reference.
    io0 = [reg.io_reads for reg in regs]
    for sid in (3, 40, 41, 1700, 1990, 1999):
        (jp, jv), (p, v) = (reg.live_pages(sid) for reg in regs)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(v, jv)
        assert len(p) == (0 if sid in (3, 1700, 1990) else 4)
    batch = [3, 4, 40, 1805, 1999]
    for (jp, jv), (p, v) in zip(*(reg.live_pages_batch(batch)
                                  for reg in regs)):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(v, jv)
    assert regs[0].io_reads - io0[0] == regs[1].io_reads - io0[1]


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                "--steps", "3"])
    out = capsys.readouterr().out
    assert "generated (4, 3) on cpu" in out
