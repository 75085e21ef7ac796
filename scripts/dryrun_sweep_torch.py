"""Run the port's whole dry-run sweep, one process per cell, several at a
time: ``python -m repro_torch.launch.dryrun --all --both`` split by
``--cell`` (a process has one fake group, ``launch/mesh.py``).

    PYTHONPATH=src python scripts/dryrun_sweep_torch.py --device cpu \
        [--jobs 6] [--out artifacts/dryrun_torch] \
        [--opt-out artifacts/dryrun_torch_opt]

The base sweep is every (arch x shape x mesh) cell into ``--out``; the opt
sweep is ``gen_experiments_torch.CELLS`` at pod16x16 with
``REPRO_MICROBATCH=4`` into ``--opt-out``.  The cells start heaviest first
(``prefill_32k``, then ``train_4k``, deeper models first).  Records are
resumable: a cell whose record exists is not run again, except an
``error`` record, which is re-run.  Each cell's output goes to
``<dir>/logs/<cell>.log``; ``<dir>/host.txt`` names the card
(``nvidia-smi``'s name and power limit) or the CPU, the fake tensors'
device type and the torch version, for ``gen_experiments_torch``.  The
last line of standard output is one JSON
object ``{"base": {status: n}, "opt": {status: n}, "seconds": s}``; the
exit code is 1 when a cell ended neither ``ok`` nor ``skipped``.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from gen_experiments_torch import CELLS as OPT_CELLS  # noqa: E402
from repro_torch.launch.shapes import SHAPES  # noqa: E402
from repro_torch.models import all_names, get_config  # noqa: E402

OPT_MICROBATCH = 4
MESHES = ("pod2x16x16", "pod16x16")
_SHAPE_ORDER = ("prefill_32k", "train_4k", "decode_32k", "long_500k")


def base_cells():
    """Every cell of ``--all --both``, heaviest first."""
    cells = [(a, s, m) for a in all_names() for s in SHAPES for m in MESHES]
    return sorted(cells, key=lambda c: (_SHAPE_ORDER.index(c[1]),
                                        -get_config(c[0]).num_layers,
                                        MESHES.index(c[2])))


def _record(outdir: pathlib.Path, cell):
    p = outdir / ("__".join(cell) + ".json")
    return json.loads(p.read_text()) if p.exists() else None


def host_line(device: str) -> str:
    import torch
    if device == "cuda":
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        where = f"the host's CPU ({os.cpu_count()} cores)"
    return f"{where}; --device {device}; torch {torch.__version__}"


def run(jobs, device, plan):
    """Run ``plan`` ([(outdir, cell, env)]) with at most ``jobs`` processes
    at once; returns each cell's final record."""
    pending = []
    for outdir, cell, env in plan:
        rec = _record(outdir, cell)
        if rec is None or rec["status"] == "error":
            pending.append((outdir, cell, env))
    running = []
    while pending or running:
        while pending and len(running) < jobs:
            outdir, cell, env = pending.pop(0)
            log_dir = outdir / "logs"
            log_dir.mkdir(parents=True, exist_ok=True)
            log = open(log_dir / ("__".join(cell) + ".log"), "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--device", device, "--out", str(outdir), "--force",
                   "--cell", ":".join(cell)]
            running.append((subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
                env=env), log, outdir, cell))
        time.sleep(1.0)
        for item in list(running):
            proc, log, outdir, cell = item
            if proc.poll() is None:
                continue
            log.close()
            running.remove(item)
            rec = _record(outdir, cell) or {"status": "error",
                                            "error": f"exit {proc.returncode}"}
            extra = (f"run={rec.get('run_s')}s" if rec["status"] == "ok"
                     else rec.get("error", rec.get("reason", ""))[:120])
            print(f"[{rec['status']:7s}] {':'.join(cell)} {extra}",
                  flush=True)
    return [(outdir, cell, _record(outdir, cell)) for outdir, cell, _ in plan]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "dryrun_torch"))
    ap.add_argument("--opt-out",
                    default=str(ROOT / "artifacts" / "dryrun_torch_opt"))
    args = ap.parse_args(argv)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")]))}
    env.pop("REPRO_MICROBATCH", None)
    env.setdefault("OMP_NUM_THREADS", "1")     # fake tensors: no arithmetic
    opt_env = {**env, "REPRO_MICROBATCH": str(OPT_MICROBATCH)}
    base_dir, opt_dir = pathlib.Path(args.out), pathlib.Path(args.opt_out)
    plan = [(opt_dir, (a, s, "pod16x16"), opt_env) for a, s in OPT_CELLS]
    plan += [(base_dir, c, env) for c in base_cells()]
    plan.sort(key=lambda p: _SHAPE_ORDER.index(p[1][1]))     # stable
    host = host_line(args.device)
    for d in {p[0] for p in plan}:
        d.mkdir(parents=True, exist_ok=True)
        (d / "host.txt").write_text(host + "\n")
    t0 = time.time()
    results = run(args.jobs, args.device, plan)
    tally = {"base": {}, "opt": {}}
    for outdir, _, rec in results:
        part = tally["opt" if outdir == opt_dir else "base"]
        status = rec["status"] if rec else "missing"
        part[status] = part.get(status, 0) + 1
    bad = sum(n for part in tally.values() for s, n in part.items()
              if s not in ("ok", "skipped"))
    print(json.dumps({**tally, "seconds": round(time.time() - t0, 1)}))
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
