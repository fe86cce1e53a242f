"""The port's examples against the reference's, on the CPU.

``examples/torch_{quickstart,cognitive_assistance,train_lm}.py`` are twins
of the reference's three examples on ``repro_torch``.  Each reference
example's ``main`` runs here in process (all three run on this JAX):

* quickstart: the twin's printed lines equal the reference's, every one;
* cognitive assistance: the twin, given the reference's reduced
  phi-3-vision weights (``PRNGKey(0)``) through ``convert.model_from_jax``,
  prints the reference's lines (the re-partition event, hits by kind,
  executions per replica) but for the wall time, and its fleet stats equal
  the reference's; both at a fixed virtual execution time (each example's
  ``ServingFleet`` replaced by a subclass that sets its engine's
  ``exec_time_fn``), since in wall time the hits change from run to run on
  either side;
* train_lm at ``--width 64 --seq-len 32 --batch 2``: 3 steps from the
  reference's weights print the reference's lines (numbers within 1e-4
  relative or the last printed digit, the seconds left out), and their
  unrounded losses are within 1e-4 relative of the reference's loop
  (``make_train_step`` with 2 microbatches, bf16 moments, the same
  batches); each side's state after its third step is saved by its own
  ``save`` under ``tmp_path``, at the label the mains use, and each side's
  ``main`` with ``--steps 5`` resumes from its own and prints the same
  lines;
* without a card, every twin's ``main`` raises when ``--device`` is not
  given.
"""
import dataclasses
import importlib.util
import re
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro_torch.configs import get_arch
from repro_torch.convert import model_from_jax

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
REL_TOL = 1e-4
NUM = re.compile(r"-?\d+\.?\d*(?:e[-+]\d+)?")
W64 = ["--width", "64", "--seq-len", "32", "--batch", "2"]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_main(name: str, capsys, monkeypatch, argv=()):
    """Run the reference example's ``main`` in process; its printed lines."""
    mod = _load(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.rstrip("\n").split("\n")


def _printed(lines):
    """Lines as ``print`` shows them (a line may start with a newline)."""
    return "\n".join(lines).split("\n")


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_lines(got, want, skip_seconds=False):
    """Same text with the numbers taken out; each number within REL_TOL
    relative or one unit of its last printed digit."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if skip_seconds:
            g, w = (re.sub(r"in \d+s;", "in _s;", x) for x in (g, w))
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
        for a, b in zip(NUM.findall(g), NUM.findall(w)):
            unit = 10.0 ** -len(b.split("e")[0].split(".")[1]) if "." in b else 1.0
            assert abs(float(a) - float(b)) <= max(REL_TOL * abs(float(b)), unit), (g, w)


def test_quickstart_prints_the_reference_lines(capsys, monkeypatch):
    want = _ref_main("quickstart", capsys, monkeypatch)
    twin = _load("torch_quickstart")
    assert _printed(twin.report(twin.run("cpu"))) == want


@pytest.mark.parametrize("exec_s", [0.005, 0.05])
def test_cognitive_assistance_matches_the_reference(capsys, monkeypatch, exec_s):
    """An execution takes its wall time on the fleet's virtual clock in both
    examples, so their hits by kind and backups change from run to run (the
    reference's own runs here print 76 or 77 EN hits).  Both sides take a
    fixed virtual execution time instead, through their engine's
    ``exec_time_fn``."""
    mod = _load("cognitive_assistance")
    fleets = _fixed_exec_time(monkeypatch, mod, exec_s)
    monkeypatch.setattr(sys, "argv", ["cognitive_assistance.py"])
    capsys.readouterr()
    mod.main()
    want = capsys.readouterr().out.rstrip("\n").split("\n")
    jcfg = j_get_arch("phi-3-vision-4.2b").reduced()
    params = _tree_np(j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    model = model_from_jax(get_arch("phi-3-vision-4.2b").reduced(), params, "cpu")
    twin = _load("torch_cognitive_assistance")
    twin_fleets = _fixed_exec_time(monkeypatch, twin, exec_s)
    res = twin.run("cpu", params=dict(model.named_parameters()))
    got = _printed(twin.report(res))
    wall = re.compile(r"in [\d.]+s across")
    assert [wall.sub("in _s across", x) for x in got] == [
        wall.sub("in _s across", x) for x in want]
    assert twin.LOST in got
    assert res["stats"] == fleets[0].stats() == twin_fleets[0].stats()


def _fixed_exec_time(monkeypatch, mod, exec_s: float) -> list:
    """Replace ``mod.ServingFleet`` by a subclass whose engine gives every
    execution ``exec_s`` of virtual time; returns the fleets it makes."""
    fleets = []

    class Fleet(mod.ServingFleet):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.engine.exec_time_fn = lambda rid, service, reqs: exec_s
            fleets.append(self)

    monkeypatch.setattr(mod, "ServingFleet", Fleet)
    return fleets


def _ref_lm(width: int = 64):
    """The reference example's config, model and init weights."""
    w = width
    cfg = dataclasses.replace(
        j_get_arch("qwen3-1.7b"), n_layers=8, d_model=w, n_heads=8,
        n_kv_heads=4, head_dim=w // 8, d_ff=4 * w, vocab_size=50_304,
        dtype="float32", loss_chunk=128)
    model = j_build_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def test_train_lm_matches_the_reference_and_restarts(tmp_path, capsys, monkeypatch):
    from repro.configs import ShapeSpec as JShape
    from repro.launch.train import synthetic_batch as j_synthetic_batch
    from repro.training import OptimizerConfig as JOpt
    from repro.training import adamw_init as j_adamw_init
    from repro.training import make_train_step as j_make_train_step
    from repro.training import save as j_save
    from repro_torch.training import save

    twin = _load("torch_train_lm")
    jcfg, jmodel, jparams = _ref_lm()
    port = model_from_jax(twin.lm_config(64), _tree_np(jparams), "cpu", trainable=True)
    params = {n: p.detach().clone() for n, p in port.named_parameters()}
    # each side's main, 3 steps (neither saves a checkpoint before step 100)
    want = _ref_main("train_lm", capsys, monkeypatch,
                     ["--steps", "3", *W64, "--ckpt-dir", str(tmp_path / "ref_main")])
    got = twin.run(["--steps", "3", *W64, "--ckpt-dir", str(tmp_path / "port_main")],
                   device="cpu", params=params)
    _close_lines(_printed(got["lines"]), want, skip_seconds=True)
    # the reference's loop as its main runs it: every step's unrounded loss,
    # and its state after step index 2 saved as its main labels it (2)
    ocfg = JOpt(lr=6e-4, warmup_steps=20, total_steps=3, moment_dtype="bfloat16")
    step_fn = jax.jit(j_make_train_step(jmodel, ocfg, microbatches=2))
    state = {"params": jparams, "opt": j_adamw_init(jparams, ocfg)}
    shape = JShape("train", 32, 2, "train")
    losses = []
    for step in range(3):
        state, metrics = step_fn(state, j_synthetic_batch(jmodel, jcfg, shape, step % 64))
        losses.append(float(metrics["loss"]))
    logged = {s: loss for s, loss, _, _ in got["logged"]}
    for s, loss in logged.items():
        assert abs(loss - losses[s]) <= REL_TOL * abs(losses[s]), (s, loss, losses[s])
    assert got["final"] == logged[2]
    j_save(state, str(tmp_path / "ref"), 2)
    save(got["state"], str(tmp_path / "port"), 2)
    # each side's main resumes from its own checkpoint and takes steps 3, 4
    want = _ref_main("train_lm", capsys, monkeypatch,
                     ["--steps", "5", *W64, "--ckpt-dir", str(tmp_path / "ref")])
    assert want[1] == "resumed from checkpoint at step 3"
    twin_main = _load("torch_train_lm")
    capsys.readouterr()
    twin_main.main(["--steps", "5", *W64, "--ckpt-dir", str(tmp_path / "port"),
                    "--device", "cpu"])
    got = capsys.readouterr().out.rstrip("\n").split("\n")
    _close_lines(got, want, skip_seconds=True)


def test_train_lm_checkpoints_under_its_own_temp_dir(tmp_path, monkeypatch):
    """The twin's default checkpoint directory follows the temporary
    directory and is not the reference's."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = _load("torch_train_lm").parse_args([])
    assert args.ckpt_dir == str(tmp_path / "repro_torch_train_lm")


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_cognitive_assistance",
                                  "torch_train_lm"])
def test_twins_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the twins run on it by default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])
