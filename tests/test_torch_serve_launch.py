"""The port's serve launcher and synthetic datasets against the JAX package's.

* ``make_stream`` is bit-equal to the reference's for every ``DATASETS``
  entry (embeddings and labels), and so are the dataset services' labels.
* ``main(argv, device="cpu")`` with ``--engine sync`` and ``--engine async``
  at 8 requests prints the reference CLI's summary lines (numbers aside; the
  sync run's reuse counts are equal, since they do not depend on wall time).
* ``--offload-policy`` and ``--trace-out`` need ``--engine cosim`` (the
  reference's errors).  ``--engine cosim --offload-policy local-only`` runs
  and prints the reference's summary lines, its ``federation[local-only]``
  line equal (``--engine cosim`` itself: tests/test_torch_cosim.py).
"""
import re
import sys

import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro_torch.data import DATASETS, dataset_service, make_stream
from repro_torch.launch.serve import main

LATENCY = re.compile(r"  latency\[(cs     |en     |scratch)\] mean= *[\d.]+ ms  n=\d+")
SPEEDUP = re.compile(r"  speedup cs vs scratch: [\d.]+x")


class TestSyntheticStreams:
    @pytest.mark.parametrize("name", sorted(jsyn.DATASETS))
    @pytest.mark.parametrize("n,seed", [(257, 0), (64, 5)])
    def test_make_stream_bit_equal(self, name, n, seed):
        assert DATASETS[name] == DATASETS[name].__class__(**vars(jsyn.DATASETS[name]))
        x, y = make_stream(DATASETS[name], n, seed=seed)
        jx, jy = jsyn.make_stream(jsyn.DATASETS[name], n, seed=seed)
        assert x.dtype == jx.dtype and y.dtype == jy.dtype
        assert np.array_equal(x, jx) and np.array_equal(y, jy)

    @pytest.mark.parametrize("name", sorted(jsyn.DATASETS))
    def test_dataset_service_labels_equal(self, name):
        x, _ = make_stream(DATASETS[name], 40, seed=1)
        svc, jsvc = dataset_service(DATASETS[name]), jsyn.dataset_service(jsyn.DATASETS[name])
        assert (svc.name, svc.exec_time_s, svc.input_dim) == (
            jsvc.name, jsvc.exec_time_s, jsvc.input_dim)
        assert [svc.execute(v) for v in x] == [jsvc.execute(v) for v in x]


def _lines(text):
    return [line for line in text.splitlines() if line.strip()]


def _mask(line):
    return re.sub(r"\d+(\.\d+)?", "#", line)


def _run_reference(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    return _lines(capsys.readouterr().out)


class TestServeMain:
    @pytest.mark.parametrize("engine", ["sync", "async"])
    def test_prints_the_reference_summary(self, engine, monkeypatch, capsys):
        argv = ["--engine", engine, "--requests", "8"]
        ref = _run_reference(monkeypatch, capsys, argv)
        main(argv, device="cpu")
        out = _lines(capsys.readouterr().out)
        assert out[0] == "serving qwen3-1.7b (reduced: 2 layers, d_model 64) on cpu"
        out = out[1:]
        # the header, the reuse counts and (async) the backup line
        fixed = 3 if engine == "async" else 2
        assert [_mask(line) for line in out[:fixed]] == [_mask(line) for line in ref[:fixed]]
        counts = [int(v) for v in re.findall(r"=(\d+)", out[1])]
        assert sum(counts) == 8 and len(counts) == 4
        for lines in (out[fixed:], ref[fixed:]):     # which kinds occur varies
            assert lines and all(LATENCY.fullmatch(x) or SPEEDUP.fullmatch(x) for x in lines)
        if engine == "sync":
            assert out[1] == ref[1]    # one execution: no backup can fire

    @pytest.mark.parametrize("flags", [["--offload-policy", "least-loaded"],
                                       ["--trace-out", "trace.json"]])
    def test_cosim_flags_name_the_simulator_slice(self, flags, capsys):
        """The co-simulation's flags outside it exit as in the reference."""
        with pytest.raises(SystemExit) as ei:
            main(flags + ["--requests", "2"], device="cpu")
        assert ei.value.code == 2
        assert f"{flags[0]} requires --engine cosim" in capsys.readouterr().err

    def test_cosim_offload_policy_prints_the_federation_line(self, monkeypatch, capsys):
        """``--engine cosim --offload-policy local-only`` runs the federated
        co-simulation: the reference's summary lines (numbers aside), and
        the same ``federation[local-only]`` line (local-only never offloads,
        whatever the wall-time clock does)."""
        argv = ["--engine", "cosim", "--offload-policy", "local-only", "--requests", "8"]
        ref = _run_reference(monkeypatch, capsys, argv)
        main(argv, device="cpu")
        out = _lines(capsys.readouterr().out)[1:]
        fed = [line for line in out if line.strip().startswith("federation[")]
        assert fed == [line for line in ref if line.strip().startswith("federation[")]
        assert fed == ["  federation[local-only]: offloads=0 remote_hits=0 remote_execs=0 "
                       "rebalances=0"]
        head = [_mask(line) for line in out if not LATENCY.fullmatch(line)
                and not SPEEDUP.fullmatch(line)]
        want = [_mask(line) for line in ref if not LATENCY.fullmatch(line)
                and not SPEEDUP.fullmatch(line)]
        assert head == want

    def test_rejects_unknown_dataset(self, capsys):
        with pytest.raises(SystemExit):
            main(["--dataset", "imagenet"], device="cpu")
        assert "invalid choice" in capsys.readouterr().err
