"""Rank 0's FLOPs of one dry-run cell, op by op, in either package.

``python tests/dryrun_flops_by_op.py {ref|port} ARCH:SHAPE [--top N]``
(with ``src`` on ``PYTHONPATH``) lowers the cell on the 16 x 16 mesh
("fsdp") as each package's dry run does and prints one JSON line: the
cell's total FLOPs and its N largest ops by FLOPs, each with its count.

* ``ref``: ``repro.launch.dryrun.lower_cell`` (XLA on 512 host devices);
  each ``dot`` of the compiled, partitioned HLO, keyed by its operand
  shapes, its FLOPs times the trip counts of the ``while`` bodies around
  it (``repro.launch.hlo_analysis``'s convention); and, keyed "fused
  dot", each dot inside a fusion, which that walk does not count (XLA's
  CPU backend fuses a matrix-vector product, a batch-1 decode's, into a
  loop fusion).  ``flops`` is the walk's total; ``fused_flops`` the fused
  dots'.
* ``port``: ``repro_torch.launch.dryrun.lower_cell`` with fake CPU tensors
  in a fake world of 256 ranks; each ATen op with FLOPs, keyed by its
  operand shapes, and each attention kernel's recorded work.

The two keys differ in form (HLO types, ATen shapes); what they count is
the same per-device work.
"""
from __future__ import annotations

import json
import re
import sys
from collections import defaultdict


def ref_ops(cell: str) -> tuple:
    from repro.launch import dryrun
    from repro.launch import hlo_analysis as ha

    texts = []
    analyze = ha.analyze

    def keep(hlo):
        texts.append(hlo)
        return analyze(hlo)

    dryrun.hlo_analysis.analyze = keep
    arch, shape = cell.split(":")
    res = dryrun.lower_cell(arch, shape)
    comps, per = {}, {}
    cur = None
    for raw in texts[0].splitlines():
        line = raw.strip()
        m = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s+->\s+.*\{\s*$", line)
        if m:
            cur = comps.setdefault(m.group(1), {"dots": defaultdict(float), "calls": []})
            if raw.startswith("ENTRY"):
                comps["__entry__"] = cur
            types = {}
            continue
        if cur is None or "=" not in line:
            continue
        name_m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        body = line[line.index("=") + 1:]
        opm = ha._OP_RE.search(body)
        if not opm:
            continue
        op, type_str = opm.group(1), body[:opm.start() + 1]
        if name_m:
            types[name_m.group(1)] = type_str.strip()
        args = body[opm.end():]
        if op == "while":
            bm, tm = re.search(r"body=%?([\w.\-]+)", args), \
                re.search(r"known_trip_count[^\d]*(\d+)", args)
            if bm:
                cur["calls"].append((bm.group(1), int(tm.group(1)) if tm else 1))
        elif op in ("call", "conditional", "async-start", "fusion"):
            for cm in re.finditer(r"(?:to_apply|called_computation[s]?|branch_computations|"
                                  r"calls)=\{?%?([\w.\-]+)", args):
                cur["calls"].append((cm.group(1), 1))
        elif op == "dot":
            operands = re.findall(r"%([\w.\-]+)", args.split(")")[0])
            lhs = ha._shape_dims(types.get(operands[0], ""))
            cm = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", args)
            k = 1
            if cm and lhs:
                for d in cm.group(1).split(","):
                    if d:
                        k *= lhs[0][int(d)]
            _, elems = ha._type_bytes_and_elems(type_str)
            key = "dot " + " x ".join(types.get(o, "?").split("{")[0] for o in operands[:2])
            cur["dots"][key] += 2.0 * elems * k

    fused = {c for comp in comps.values() for c, _ in comp["calls"] if c.startswith("fused")}

    def walk(name, mult, inside=False, depth=0):
        if depth > 64 or name not in comps:
            return
        inside = inside or name in fused
        for key, f in comps[name]["dots"].items():
            key = ("fused " if inside else "") + key
            per.setdefault(key, [0.0, 0])
            per[key][0] += mult * f
            per[key][1] += mult
        for callee, trip in comps[name]["calls"]:
            walk(callee, mult * trip, inside, depth + 1)

    walk("__entry__", 1)
    return res["hlo_flops"], per


def port_ops(cell: str) -> tuple:
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import start_fake_world

    per = {}
    dispatch, kernel = hlo_analysis._Profile.__torch_dispatch__, hlo_analysis._Profile.kernel

    def add(key, flops):
        per.setdefault(key, [0.0, 0])
        per[key][0] += flops
        per[key][1] += 1

    def watching(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = dispatch(self, func, types, args, kwargs)
        if out is not NotImplemented and not self.skip and self.flops > before:
            shapes = [list(a.shape) for a in args if hasattr(a, "shape")]
            add(f"{func._overloadpacket.__name__} {shapes}", self.flops - before)
        return out

    def kernels(self, name, flops, n_bytes, transcendental):
        if not self.skip and flops:
            add(f"kernel {name}", flops)
        return kernel(self, name, flops, n_bytes, transcendental)

    hlo_analysis._Profile.__torch_dispatch__ = watching
    hlo_analysis._Profile.kernel = kernels
    start_fake_world(256)
    arch, shape = cell.split(":")
    res = dryrun.lower_cell(arch, shape, device="cpu")
    return res["hlo_flops"], per


def main(argv) -> None:
    which, cell = argv[0], argv[1]
    top = int(argv[argv.index("--top") + 1]) if "--top" in argv else 12
    total, per = (ref_ops if which == "ref" else port_ops)(cell)
    ops = sorted(per.items(), key=lambda kv: -kv[1][0])[:top]
    fused = sum(f for k, (f, _) in per.items() if k.startswith("fused"))
    print(json.dumps({"package": which, "cell": cell, "flops": total, "fused_flops": fused,
                      "top": [{"op": k, "flops": f, "count": n} for k, (f, n) in ops]}))


if __name__ == "__main__":
    main(sys.argv[1:])
