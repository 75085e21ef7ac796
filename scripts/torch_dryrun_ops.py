"""Which ops a dry-run cell's counts come from: run one cell of the port's
dry run (``repro_torch.launch.dryrun.run_cell``) on the 16x16 mesh and
print, per device, its dot ops grouped by op name and local operand shapes
(count and FLOPs), and the number of every op it dispatched.

    PYTHONPATH=src python scripts/torch_dryrun_ops.py olmoe-1b-7b decode_32k \
        [--device cpu] [--out ops.json]

The last line of standard output is one JSON object ``{"cell", "torch",
"device", "flops", "dots": {"op[shapes]": [count, flops]}, "ops": {name:
count}}``; two runs (another torch, another device type) diff key by key.
"""
import argparse
import json
import pathlib
import sys
import tempfile

import torch

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as ME
from repro_torch.launch import op_analysis


class DotRecorder(op_analysis.OpCounter):
    """An :class:`~repro_torch.launch.op_analysis.OpCounter` that also keeps
    each counted op's name and each dot op's local operand shapes."""
    last = None

    def __init__(self):
        super().__init__()
        self.dots = {}
        self.names = {}
        DotRecorder.last = self

    def _count(self, func, args, kwargs, out):
        before = self.flops
        super()._count(func, args, kwargs, out)
        name = f"{func.namespace}.{func._opname}"
        self.names[name] = self.names.get(name, 0) + 1
        if func._opname in op_analysis._DOT_OPS:
            shapes = [list(t.shape) for t in op_analysis._tensors(args)]
            key = f"{name}{shapes}"
            n, f = self.dots.get(key, (0, 0.0))
            self.dots[key] = (n + 1, f + self.flops - before)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    ME.fake_group(256)
    op_analysis.OpCounter = DotRecorder     # run_counted builds this one
    with tempfile.TemporaryDirectory() as tmp:
        rec = dryrun.run_cell(args.arch, args.shape, False,
                              pathlib.Path(tmp), force=True,
                              device=args.device)
    ME.release()
    if rec["status"] != "ok":
        print(rec.get("traceback", rec), file=sys.stderr)
        return 1
    c = DotRecorder.last
    row = {"cell": f"{args.arch}:{args.shape}:{rec['mesh']}",
           "torch": torch.__version__, "device": args.device,
           "flops": c.flops, "dots": dict(sorted(c.dots.items())),
           "ops": dict(sorted(c.names.items()))}
    for key, (n, f) in row["dots"].items():
        print(f"{f:14.6e} {n:6d} {key}")
    text = json.dumps(row)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
