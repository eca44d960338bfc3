"""The port's training substrate against the JAX package's on the CPU:
``TokenPipeline`` batches bit for bit, ``StragglerDetector`` events,
checkpoints (round trip, keep-last-k, and each package restoring the
other's), the reference's four train-loop cases on the port, and
``run_training`` from one shared step-0 checkpoint giving the
reference's losses within 1e-5.
"""

import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import get_config, smoke
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import Transformer as JTransformer
from repro.models import tree_init
from repro.optim import adamw_init as jadamw_init
from repro.runtime import StragglerDetector as JStragglerDetector
from repro.runtime import TrainLoopConfig as JTrainLoopConfig
from repro.runtime import run_training as jrun_training
from repro_torch.carry import jax_params, load_jax_params, param_leaves, \
    param_template
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import smoke as tsmoke
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.models import Transformer
from repro_torch.optim import adamw_init
from repro_torch.runtime import (StragglerDetector, TrainLoopConfig,
                                 TransientFailure, run_training)

torch.set_num_threads(1)

ARCH = "h2o-danube-3-4b"  # the reference's train-loop tests' model


def tiny_model(dtype="float32"):
    from dataclasses import replace
    return Transformer(replace(tsmoke(tget_config(ARCH)), dtype=dtype),
                       device="cpu")


def tiny_pipeline(cfg, n_hosts=1, host_id=0):
    return TokenPipeline(PipelineConfig(vocab=cfg.vocab, global_batch=4,
                                        seq_len=16, seed=7, n_hosts=n_hosts,
                                        host_id=host_id))


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed,n_hosts,host_id,embeds", [
    (7, 1, 0, False), (0, 2, 1, False), (123, 4, 3, False),
    (5, 2, 0, True)])
def test_pipeline_batches_are_the_reference(seed, n_hosts, host_id, embeds):
    kw = dict(vocab=256, global_batch=8, seq_len=12, seed=seed,
              n_hosts=n_hosts, host_id=host_id, emit_embeddings=embeds,
              d_model=6)
    mine, ref = TokenPipeline(PipelineConfig(**kw)), \
        JTokenPipeline(JPipelineConfig(**kw))
    for _ in range(4):
        a, b = mine.next(), ref.next()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state() == ref.state()
    mine.restore({"step": 2, "seed": seed})
    ref.restore({"step": 2, "seed": seed})
    np.testing.assert_array_equal(mine.next()["labels"],
                                  ref.next()["labels"])


def test_straggler_events_equal_the_reference():
    rng = np.random.default_rng(0)
    mine, ref = StragglerDetector(n_hosts=4), JStragglerDetector(n_hosts=4)
    for step in range(30):
        d = list(0.1 + 0.01 * rng.random(4))
        if step >= 12:
            d[1] = 0.9
        assert mine.observe(step, d) == ref.observe(step, d)
    assert mine.events == ref.events and mine.events


# ------------------------------------------------------------ checkpoint
def test_checkpoint_round_trip_and_keep_last_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(12.0).reshape(3, 4).to(torch.bfloat16),
             "nested": {"b": torch.ones(5), "step": torch.tensor(
                 3, dtype=torch.int32)}}
    m.save(10, state, extra={"step": 10, "pipeline": {"step": 3,
                                                      "seed": 7}})
    m.wait()
    got, extra = m.restore(state)
    for k, v in flat(state):
        g = dict(flat(got))[k]
        assert g.dtype == v.dtype and torch.equal(g, v), k
    assert extra["step"] == 10
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    for step in (11, 12, 13):
        m.save(step, state, blocking=True)
    assert m.list_steps() == [12, 13] and m.latest_step() == 13


def test_async_save_keeps_the_state_as_it_was(tmp_path):
    """An async save holds the state of its step even when the next
    step updates the tensors in place before the writer gets to them."""
    m = CheckpointManager(str(tmp_path))
    go = threading.Event()
    write = m._write
    m._write = lambda job: (go.wait(), write(job))
    state = {"mu": torch.arange(6.0).reshape(2, 3),
             "w": torch.ones(4, dtype=torch.bfloat16),
             "count": torch.tensor(5, dtype=torch.int32),
             "host": np.arange(3, dtype=np.float32)}
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v.copy())
              for k, v in state.items()}
    m.save(1, state)
    state["mu"].mul_(0.5).add_(1.0)
    state["w"].add_(1.0)
    state["count"].add_(1)
    state["host"] += 1.0
    go.set()
    m.wait()
    got, _ = m.restore(before)
    for k, v in before.items():
        g = got[k]
        same = torch.equal(g, v) if isinstance(v, torch.Tensor) else \
            np.array_equal(g, v)
        assert same, (k, g, v)


def reference_state(dtype):
    cfg = smoke(get_config(ARCH))
    jm = JTransformer(cfg)
    params = tree_init(jm.param_specs(), jax.random.key(3), dtype)
    return params, jadamw_init(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_reference_checkpoint(tmp_path, dtype):
    """The reference writes params + AdamW state (its bf16 leaves as raw
    2-byte words); the port restores them into a model equal to
    ``load_jax_params``'s and into its own optimizer state."""
    params, opt = reference_state(getattr(jnp, dtype))
    opt = jax.tree.map(lambda x: x + 0.5 if x.dtype == jnp.float32 else x,
                       opt)
    JCheckpointManager(str(tmp_path)).save(
        4, {"params": params, "opt": opt}, extra={"step": 4},
        blocking=True)
    model = tiny_model(dtype)
    want = tiny_model(dtype)
    load_jax_params(want, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), params))
    state = adamw_init(param_leaves(model))
    got, extra = CheckpointManager(str(tmp_path)).restore(
        {"params": param_template(model), "opt": state})
    load_jax_params(model, got["params"])
    assert extra == {"step": 4}
    for (k, a), (_, b) in zip(model.params.named_parameters(),
                              want.params.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    jopt = dict(flat(jax.tree.map(np.asarray, opt)))
    for k, v in flat(got["opt"]):
        np.testing.assert_array_equal(v.numpy(), jopt[k], err_msg=k)


def test_reference_restores_port_bf16_checkpoint(tmp_path):
    """The port writes a bf16 model (as f32) and its AdamW state; the
    reference restores them exactly into bf16 / f32 templates."""
    model = tiny_model("bfloat16")
    state = adamw_init(param_leaves(model))
    state["step"] += 2
    CheckpointManager(str(tmp_path)).save(
        2, {"params": jax_params(model), "opt": state},
        extra={"step": 2}, blocking=True)
    params, opt = reference_state(jnp.bfloat16)
    got, extra = JCheckpointManager(str(tmp_path)).restore(
        {"params": params, "opt": opt})
    assert extra == {"step": 2} and int(got["opt"]["step"]) == 2
    want = jax_params(model)
    for k, v in flat(got["params"]):
        assert v.dtype == jnp.bfloat16, k
        np.testing.assert_array_equal(np.asarray(v.astype(jnp.float32)),
                                      dict(flat(want))[k], err_msg=k)


# ------------------------------------------------------------ train loop
class TestTrainLoop:
    """The reference's ``tests/test_runtime.py::TestTrainLoop`` on the
    port."""

    def test_loss_decreases(self, tmp_path):
        model = tiny_model()
        pipe = tiny_pipeline(model.cfg)
        res = run_training(model, pipe, TrainLoopConfig(
            total_steps=20, checkpoint_every=10,
            checkpoint_dir=str(tmp_path)))
        assert res.final_step == 20
        assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])

    def test_transient_failures_are_retried(self, tmp_path):
        model = tiny_model()
        pipe = tiny_pipeline(model.cfg)
        fail_at = {3: 2, 7: 1}  # step -> remaining failures

        def injector(step):
            if fail_at.get(step, 0) > 0:
                fail_at[step] -= 1
                return True
            return False

        res = run_training(model, pipe, TrainLoopConfig(
            total_steps=10, checkpoint_every=5,
            checkpoint_dir=str(tmp_path)), failure_injector=injector)
        assert res.final_step == 10
        assert res.retries == 3

    def test_crash_resume_continues_from_checkpoint(self, tmp_path):
        model = tiny_model()
        pipe = tiny_pipeline(model.cfg)
        cfgA = TrainLoopConfig(total_steps=10, checkpoint_every=5,
                               checkpoint_dir=str(tmp_path))

        def hard_fail(step):
            if step == 7:
                raise RuntimeError("simulated node loss")
            return False

        with pytest.raises(RuntimeError):
            run_training(model, pipe, cfgA, failure_injector=hard_fail)
        pipe2 = tiny_pipeline(model.cfg)
        res = run_training(model, pipe2, cfgA)
        assert res.resumed_from == 5
        assert res.final_step == 10
        assert pipe2.step == 10  # pipeline state also resumed

    def test_straggler_events_detected(self, tmp_path):
        model = tiny_model()

        def durations(step, real):
            base = [0.1, 0.1, 0.1, 0.1]
            if step >= 8:
                base[2] = 0.9  # host 2 goes slow
            return base

        det_pipe = TokenPipeline(PipelineConfig(
            vocab=model.cfg.vocab, global_batch=4, seq_len=16, seed=7,
            n_hosts=4, host_id=0))
        res = run_training(model, det_pipe, TrainLoopConfig(
            total_steps=12, checkpoint_every=50,
            checkpoint_dir=str(tmp_path)), host_durations_fn=durations)
        assert any(e["host"] == 2 for e in res.straggler_events)


def test_transient_failure_beyond_retries_raises(tmp_path):
    model = tiny_model()
    with pytest.raises(TransientFailure):
        run_training(model, tiny_pipeline(model.cfg), TrainLoopConfig(
            total_steps=3, checkpoint_dir=str(tmp_path), max_retries=1),
            failure_injector=lambda step: step == 1)


def test_run_training_matches_reference_from_shared_checkpoint(tmp_path):
    """Both packages resume one step-0 checkpoint the reference wrote
    from its ``tree_init`` and train 6 steps on the same batches (with
    a checkpoint at step 3 and a resume from it): equal losses."""
    cfg = smoke(get_config(ARCH))
    jm = JTransformer(cfg)
    params = tree_init(jm.param_specs(), jax.random.key(11), jnp.float32)
    jpipe = JTokenPipeline(JPipelineConfig(vocab=cfg.vocab, global_batch=4,
                                           seq_len=16, seed=7))
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    JCheckpointManager(str(ref_dir)).save(
        0, {"params": params, "opt": jadamw_init(params)},
        extra={"step": 0, "pipeline": jpipe.state()}, blocking=True)
    shutil.copytree(ref_dir, port_dir)
    want = jrun_training(jm, jpipe, JTrainLoopConfig(
        total_steps=6, checkpoint_every=3, checkpoint_dir=str(ref_dir)))
    model = tiny_model()
    pipe = tiny_pipeline(model.cfg)
    got = run_training(model, pipe, TrainLoopConfig(
        total_steps=3, checkpoint_every=3, checkpoint_dir=str(port_dir)))
    assert got.resumed_from == 0 and want.resumed_from == 0
    again = run_training(tiny_model(), tiny_pipeline(model.cfg),
                         TrainLoopConfig(total_steps=6, checkpoint_every=3,
                                         checkpoint_dir=str(port_dir)))
    assert again.resumed_from == 3
    np.testing.assert_allclose(got.losses + again.losses, want.losses,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m",
                                  "kimi-k2-1t-a32b", "gemma3-1b"])
def test_jax_params_round_trip(arch):
    """``jax_params`` gives the reference's tree (keys and stacked
    shapes of ``param_specs``); ``load_jax_params`` of it rebuilds the
    model exactly, bf16 included."""
    from dataclasses import replace
    cfg = replace(tsmoke(tget_config(arch)), dtype="bfloat16")
    model = Transformer(cfg, device="cpu", seed=4)
    tree = jax_params(model)
    specs = JTransformer(smoke(get_config(arch))).param_specs()
    want = {k: s.shape for k, s in flat(specs)}
    assert {k: v.shape for k, v in flat(tree)} == want
    assert all(v.dtype == np.float32 for _, v in flat(tree))
    again = Transformer(cfg, device="cpu", seed=5)
    load_jax_params(again, tree)
    for (k, a), (_, b) in zip(model.params.named_parameters(),
                              again.params.named_parameters()):
        assert torch.equal(a, b), k


def test_sigterm_takes_a_blocking_checkpoint_and_stops(tmp_path):
    """Preemption: SIGTERM during step 2 finishes that step, saves a
    checkpoint at once and stops; a new run resumes from it."""
    import signal
    model = tiny_model()

    def preempt(step):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return False

    cfg = TrainLoopConfig(total_steps=10, checkpoint_every=50,
                          checkpoint_dir=str(tmp_path))
    res = run_training(model, tiny_pipeline(model.cfg), cfg,
                       failure_injector=preempt)
    assert res.preempted and res.final_step == 3
    assert CheckpointManager(str(tmp_path)).list_steps() == [3]
    again = run_training(model, tiny_pipeline(model.cfg), cfg)
    assert again.resumed_from == 3 and again.final_step == 10
