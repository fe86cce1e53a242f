"""The port's linter (``repro_torch/analysis/lint.py``) against the
reference's (``repro/analysis/lint.py``).

* Every lint case of ``tests/test_analysis.py`` outside its J (JAX) classes
  — D001-D004, the waiver ledger (W000/W001) and the syntax-error case —
  goes through both linters, at its own path and at the same path in
  ``repro_torch``: the same codes, waived and unwaived, as that file
  expects.
* The torch rules: T001 (a compiled or loaded callable built per call),
  T002 (a host sync in per-launch code), T003 (TF32 turned on); flagged,
  cached-and-waived, shape arithmetic and the restore of a saved precision
  clean.
* The twin's own marker (``# torch-lint: waive=T00x(reason)``): W000 and
  W001 for it, a code under the other linter's marker waives nothing, and
  the reference does not read it.
* The tree: the twin over ``src/repro_torch`` reports nothing at
  ``--fail-on=warning``, and the reference over ``src`` still has no
  unwaived violation (the port's T waivers are invisible to it).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint

ROOT = Path(__file__).resolve().parents[1]
CORE = "src/repro/core/mod.py"


def codes(violations, include_waived=False):
    return [v.rule for v in violations if include_waived or not v.waived]


# (name, source, path, unwaived codes, every code): the lint cases of
# tests/test_analysis.py outside its J classes, with the codes it expects
CASES = [
    # D001
    ("builtin_hash", "x = hash('abc')\n", CORE, ["D001"], ["D001"]),
    ("hash_of_object", "def f(obj):\n    return hash(obj)\n", CORE, ["D001"], ["D001"]),
    ("hash_anywhere", "seed = hash(name) % 7\n", "src/repro/launch/mod.py", ["D001"], ["D001"]),
    ("crc32_clean", "import zlib\nseed = zlib.crc32(str(n).encode()) % 9973\n", CORE, [], []),
    ("method_hash_clean", "h = obj.hash(x)\n", CORE, [], []),
    ("hash_waived", "x = hash(k)  # lint: disable=D001(interning only, not seeding)\n", CORE,
     [], ["D001"]),
    # D002
    ("time_in_core", "import time\nt = time.time()\n", CORE, ["D002"], ["D002"]),
    ("perf_counter_in_federation", "import time\nt = time.perf_counter()\n",
     "src/repro/federation/mod.py", ["D002"], ["D002"]),
    ("datetime_in_faults", "import datetime\nt = datetime.datetime.now()\n",
     "src/repro/faults/mod.py", ["D002"], ["D002"]),
    ("aliased_time", "import time as clock\nt = clock.monotonic()\n",
     "src/repro/serving/mod.py", ["D002"], ["D002"]),
    ("from_time", "from time import time\nt = time()\n", CORE, ["D002"], ["D002"]),
    ("launch_exempt", "import time\nt = time.time()\n", "src/repro/launch/mod.py", [], []),
    ("benchmarks_exempt", "import time\nt = time.time()\n", "benchmarks/mod.py", [], []),
    ("virtual_clock_clean", "t = loop.now\n", CORE, [], []),
    ("waiver_line_above",
     "import time\n# lint: disable=D002(wall latency by design)\nt = time.perf_counter()\n",
     "src/repro/serving/mod.py", [], ["D002"]),
    # D003
    ("unseeded_random", "import random\nr = random.Random()\n", CORE, ["D003"], ["D003"]),
    ("seeded_random_clean", "import random\nr = random.Random(17)\n", CORE, [], []),
    ("global_random_draw", "import random\nx = random.randint(0, 9)\n", CORE,
     ["D003"], ["D003"]),
    ("global_np_state", "import numpy as np\nnp.random.seed(0)\n", CORE, ["D003"], ["D003"]),
    ("global_np_draw", "import numpy as np\nx = np.random.standard_normal(4)\n", CORE,
     ["D003"], ["D003"]),
    ("unseeded_default_rng", "import numpy as np\nrng = np.random.default_rng()\n", CORE,
     ["D003"], ["D003"]),
    ("seeded_default_rng_clean", "import numpy as np\nrng = np.random.default_rng(42)\n",
     CORE, [], []),
    ("system_random", "import random\nr = random.SystemRandom()\n", CORE, ["D003"], ["D003"]),
    # D004
    ("for_set_literal", "for x in {1, 2, 3}:\n    pass\n", CORE, ["D004"], ["D004"]),
    ("for_set_call", "s = set(items)\nfor x in s:\n    emit(x)\n", CORE, ["D004"], ["D004"]),
    ("list_of_set", "s = set(a)\nout = list(s)\n", CORE, ["D004"], ["D004"]),
    ("comprehension_set_attr",
     "class C:\n    def __init__(self):\n        self._dirty = set()\n"
     "    def drain(self):\n        return [p for p in self._dirty]\n", CORE,
     ["D004"], ["D004"]),
    ("join_set", "s = {'a', 'b'}\nout = ','.join(s)\n", CORE, ["D004"], ["D004"]),
    ("sorted_set_clean", "s = set(a)\nfor x in sorted(s):\n    emit(x)\n", CORE, [], []),
    ("reassigned_list_clean", "s = set(a)\ns = sorted(s)\nfor x in s:\n    emit(x)\n", CORE,
     [], []),
    ("membership_clean", "s = set(a)\nok = x in s\n", CORE, [], []),
    # the waiver ledger
    ("bare_waiver", "x = hash(k)  # lint: disable=D001\n", CORE, ["D001", "W000"],
     ["D001", "W000"]),
    ("unused_waiver", "x = 1  # lint: disable=D001(stale reason)\n", CORE, ["W001"], ["W001"]),
    ("multi_code_waiver",
     "import time\n# lint: disable=D002(bench), D001(interning)\nx = hash(str(time.time()))\n",
     CORE, [], ["D001", "D002"]),
    ("string_not_waiver", 's = "lint: disable=D001(nope)"\nx = hash(s)\n', CORE,
     ["D001"], ["D001"]),
    # a syntax error
    ("syntax_error", "def broken(:\n", CORE, ["W000"], ["W000"]),
]


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
@pytest.mark.parametrize("name,source,path,active,every", CASES, ids=[c[0] for c in CASES])
def test_twin_gives_the_reference_codes(name, source, path, active, every, package):
    """Both linters on each case, at its path and at the same path in the
    port's package: the codes test_analysis.py expects, waived or not, and
    the same waiver reasons."""
    path = path.replace("src/repro/", f"src/{package}/")
    ref, twin = ref_lint.lint_source(source, path), lint.lint_source(source, path)
    for vs in (ref, twin):
        assert sorted(codes(vs)) == sorted(active), (name, [v.format() for v in vs])
        assert sorted(codes(vs, include_waived=True)) == sorted(every), name
    assert [(v.rule, v.line, v.message, v.waive_reason) for v in twin] == \
        [(v.rule, v.line, v.message, v.waive_reason) for v in ref]


def test_rule_catalogue():
    """The reference's rules, J001/J002 replaced by T001/T002 with their
    severities, and T003."""
    want = {k: v for k, v in ref_lint.RULES.items() if not k.startswith("J")}
    assert {k: v for k, v in lint.RULES.items() if not k.startswith("T")} == want
    assert lint.RULES["T001"][0] == ref_lint.RULES["J001"][0] == "error"
    assert lint.RULES["T002"][0] == ref_lint.RULES["J002"][0] == "warning"
    assert lint.RULES["T003"][0] == "error"


KERNELS = "src/repro_torch/kernels/mod.py"
MODELS = "src/repro_torch/models/mod.py"
LOADER = ("import ctypes\n_LOADED = {}\n\n"
          "def load(name):\n"
          "    lib = _LOADED.get(name)\n"
          "    if lib is None:\n"
          "        lib = ctypes.CDLL(name)  # torch-lint: waive=T001(cached in _LOADED)\n"
          "        _LOADED[name] = lib\n"
          "    return lib\n")
AUTOGRAD = ("import torch\n\nclass Sq(torch.autograd.Function):\n"
            "    @staticmethod\n    def forward(ctx, x):\n"
            "        return x * x.sum().item()\n\n"
            "    @staticmethod\n    def backward(ctx, g):\n"
            "        print(g.tolist())\n        return g\n\n"
            "    @staticmethod\n    def helper(x):\n        return x.item()\n")
RESTORE = ("import contextlib\nimport torch\n\n@contextlib.contextmanager\n"
           "def fp32_matmul():\n"
           "    prev = torch.get_float32_matmul_precision()\n"
           "    torch.set_float32_matmul_precision(\"highest\")\n"
           "    try:\n        yield\n    finally:\n"
           "        torch.set_float32_matmul_precision(prev)\n")

# (name, source, path, unwaived codes, every code)
TORCH_CASES = [
    # T001
    ("compile_in_function", "import torch\ndef f(m):\n    return torch.compile(m)\n", MODELS,
     ["T001"], ["T001"]),
    ("jit_script_in_function", "import torch\ndef f(m):\n    return torch.jit.script(m)\n",
     MODELS, ["T001"], ["T001"]),
    ("jit_trace_in_function", "import torch\ndef f(m, x):\n    return torch.jit.trace(m, x)\n",
     MODELS, ["T001"], ["T001"]),
    ("load_inline_in_function",
     "from torch.utils.cpp_extension import load_inline\n"
     "def build(src):\n    return load_inline('k', cpp_sources=src)\n", MODELS,
     ["T001"], ["T001"]),
    ("cpp_extension_load_aliased",
     "import torch.utils.cpp_extension as ext\ndef build():\n    return ext.load('k', ['k.cu'])\n",
     MODELS, ["T001"], ["T001"]),
    ("cdll_in_loop", "import ctypes\nlibs = []\nfor p in paths:\n    libs.append(ctypes.CDLL(p))\n",
     MODELS, ["T001"], ["T001"]),
    ("nested_triton_jit", "import triton\ndef make():\n    @triton.jit\n    def kernel(x):\n"
     "        pass\n    return kernel\n", MODELS, ["T001"], ["T001"]),
    ("nested_compile_decorator", "import torch\ndef make():\n    @torch.compile\n"
     "    def step(x):\n        return x\n    return step\n", MODELS, ["T001"], ["T001"]),
    ("module_scope_clean", "import torch\nimport triton\nstep = torch.compile(fn)\n"
     "@triton.jit\ndef kernel(x):\n    pass\n", MODELS, [], []),
    ("lru_cache_clean", "import functools\nimport torch\n@functools.lru_cache(None)\n"
     "def build(n):\n    return torch.compile(fn)\n", MODELS, [], []),
    ("cached_and_waived", LOADER, KERNELS, [], ["T001"]),
    # T002
    ("item_in_autograd_forward", AUTOGRAD, MODELS, ["T002", "T002"], ["T002", "T002"]),
    ("autograd_function_imported",
     "from torch.autograd import Function\nclass F(Function):\n"
     "    @staticmethod\n    def forward(ctx, x):\n        return x.cpu()\n", MODELS,
     ["T002"], ["T002"]),
    ("int_of_tensor_in_kernels", "def launch(x):\n    return int(x.sum())\n", KERNELS,
     ["T002"], ["T002"]),
    ("cpu_numpy_in_kernels", "def launch(x):\n    return x.cpu().numpy()\n", KERNELS,
     ["T002", "T002"], ["T002", "T002"]),
    ("synchronize_in_kernels", "import torch\ndef launch(x):\n    torch.cuda.synchronize()\n",
     KERNELS, ["T002"], ["T002"]),
    ("float_in_triton_body", "import triton\n@triton.jit\ndef k(x):\n    return float(x)\n",
     MODELS, ["T002"], ["T002"]),
    ("shape_arithmetic_clean",
     "def launch(x, y):\n    B, S = int(x.shape[0]), int(x.size(1))\n"
     "    n = int(len(y) * x.ndim) + int(x.numel() // 2) - int(-y.shape[-1])\n"
     "    return B, S, n\n", KERNELS, [], []),
    ("host_numbers_clean",
     "import math\nimport numpy as np\nimport torch\nfrom typing import Optional\n"
     "def launch(q, causal: bool, scale: Optional[float] = None, window: Optional[int] = None):\n"
     "    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)\n"
     "    tc = int(q.dtype == torch.bfloat16)\n"
     "    w = -1 if window is None else int(window)\n"
     "    return int(causal), float(scale), tc, w, int(np.arange(4).sum())\n", KERNELS, [], []),
    ("sync_outside_launch_clean", "def score(x):\n    return x.max().item(), float(x.sum())\n",
     MODELS, [], []),
    ("sync_waived", "def launch(x, n):\n"
     "    # torch-lint: waive=T002(a tensor n is read on the host by design)\n"
     "    return x[:int(n)]\n", KERNELS, [], ["T002"]),
    # T003
    ("matmul_allow_tf32", "import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n",
     MODELS, ["T003"], ["T003"]),
    ("cudnn_allow_tf32", "import torch\ntorch.backends.cudnn.allow_tf32 = True\n", MODELS,
     ["T003"], ["T003"]),
    ("matmul_precision_high", "import torch\ntorch.set_float32_matmul_precision('high')\n",
     MODELS, ["T003"], ["T003"]),
    ("tl_dot_tf32", "import triton.language as tl\ndef k(a, b):\n"
     "    return tl.dot(a, b, input_precision='tf32') + tl.dot(a, b, allow_tf32=True)\n",
     MODELS, ["T003", "T003"], ["T003", "T003"]),
    ("tf32_off_clean", "import torch\nimport triton.language as tl\n"
     "torch.backends.cuda.matmul.allow_tf32 = False\n"
     "torch.set_float32_matmul_precision('highest')\n"
     "def k(a, b):\n    return tl.dot(a, b, input_precision='ieee')\n", MODELS, [], []),
    ("saved_precision_restore_clean", RESTORE, "src/repro_torch/device.py", [], []),
]


@pytest.mark.parametrize("name,source,path,active,every", TORCH_CASES,
                         ids=[c[0] for c in TORCH_CASES])
def test_torch_rules(name, source, path, active, every):
    vs = lint.lint_source(source, path)
    assert sorted(codes(vs)) == sorted(active), (name, [v.format() for v in vs])
    assert sorted(codes(vs, include_waived=True)) == sorted(every), name


def test_cached_loader_waiver_keeps_its_reason():
    vs = lint.lint_source(LOADER, KERNELS)
    assert [(v.rule, v.line, v.waived, v.waive_reason) for v in vs] == \
        [("T001", 7, True, "cached in _LOADED")]


# (name, source, path, the twin's unwaived codes, the reference's)
MARKER_CASES = [
    ("bare_torch_waiver", "def launch(x):\n    return x.item()  # torch-lint: waive=T002\n",
     KERNELS, ["T002", "W000"], []),
    ("unused_torch_waiver", "x = 1  # torch-lint: waive=T002(stale reason)\n", KERNELS,
     ["W001"], []),
    ("torch_waiver_line_above", "def launch(x):\n    # torch-lint: waive=T002(by design)\n"
     "    return x.item()\n", KERNELS, [], []),
    ("t_code_under_shared_marker",
     "def launch(x):\n    return x.item()  # lint: disable=T002(by design)\n", KERNELS,
     ["T002", "W001"], ["W001"]),
    ("d_code_under_torch_marker", "x = hash(k)  # torch-lint: waive=D001(interning)\n",
     "src/repro_torch/core/mod.py", ["D001", "W001"], ["D001"]),
    ("one_marker_a_line",
     "import time\n\ndef launch(x):\n    # torch-lint: waive=T002(by design)\n"
     "    return time.time(), x.item()  # lint: disable=D002(wall time)\n",
     "src/repro_torch/serving/kernels/mod.py", [], []),
]


@pytest.mark.parametrize("name,source,path,twin,ref", MARKER_CASES,
                         ids=[c[0] for c in MARKER_CASES])
def test_waiver_markers(name, source, path, twin, ref):
    """The twin's marker under W000/W001; a code given under the other
    linter's marker waives nothing and is unused; the reference reads only
    its own marker (and reports a T code under it as unused)."""
    assert sorted(codes(lint.lint_source(source, path))) == sorted(twin), name
    assert sorted(codes(ref_lint.lint_source(source, path))) == sorted(ref), name


def test_port_src_is_clean():
    """``python -m repro_torch.analysis.lint src/repro_torch --fail-on=warning``
    exits 0: every T hit in the port is fixed or waived with a reason."""
    vs = lint.lint_paths([ROOT / "src" / "repro_torch"])
    assert [v.format() for v in vs if not v.waived] == []
    waived = [v for v in vs if v.waived]
    assert {v.rule for v in waived} >= {"D002", "T001", "T002"}
    assert all(v.waive_reason for v in waived)
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "src/repro_torch",
                          "--fail-on=warning"], cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_reference_linter_still_clean_over_src():
    """The reference lints all of ``src``, the port and its T waivers
    included: no unwaived violation (no W001 for a twin's marker)."""
    vs = [v for v in ref_lint.lint_paths([ROOT / "src"]) if not v.waived]
    assert vs == [], "\n".join(v.format() for v in vs)


def test_cli_options():
    """The default path, ``--list-rules`` and an unknown severity."""
    assert lint.main(["--list-rules"]) == 0
    assert lint.main(["--fail-on=fatal"]) == 2
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--list-rules"],
                         cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src")}, timeout=60)
    listed = [line.split()[0] for line in run.stdout.splitlines()]
    assert listed == sorted(lint.RULES) and "J001" not in listed


def test_twin_imports_neither_torch_nor_the_reference():
    child = ("import sys; import repro_torch.analysis.lint; "
             "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')]; "
             "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", child], cwd=ROOT, capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src")}, timeout=60)
    assert out.returncode == 0, out.stderr
