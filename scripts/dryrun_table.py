#!/usr/bin/env python3
"""The dry run's records as one markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --device cpu
    python3 scripts/dryrun_table.py [artifacts/dryrun_torch]

One row an (arch, shape) of the untagged records, with each mesh's rank-0
peak live bytes in GiB, flops (in TFLOP) and collectives' wire bytes (the
reference's ring model, in GB), and whether each peak fits one 80 GB card
(peak <= 80e9 bytes); skipped and failed cells are listed under it.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CARD_BYTES = 80e9
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("16x16", "2x16x16")
PEAK, FLOPS, WIRE = "peak_memory_per_device", "flops", "collective_bytes"


def main() -> int:
    folder = (pathlib.Path(sys.argv[1]) if len(sys.argv) > 1
              else ROOT / "artifacts" / "dryrun_torch")
    rows = []
    for path in sorted(folder.glob("*.json")):
        rec = json.loads(path.read_text())
        if path.stem != f"{rec['arch']}_{rec['shape']}_{rec['mesh']}":
            continue                                   # a tagged record
        rows.append(rec)
    rows.sort(key=lambda r: (r["arch"], SHAPES.index(r["shape"]), r["mesh"]))
    cells: dict = {}
    for r in rows:
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    print("| Arch | Shape | Peak GiB 16x16 / 2x16x16 | TFLOP | Collective GB | Fits 80 GB |")
    print("| --- | --- | --- | --- | --- | --- |")
    other = []
    for (arch, shape), by_mesh in cells.items():
        ok = [by_mesh[m] for m in MESHES if m in by_mesh and by_mesh[m]["status"] == "ok"]
        other += [f"{r['arch']} {r['shape']} {r['mesh']}: {r['status']} ({r['note'][:60]})"
                  for r in by_mesh.values() if r["status"] != "ok"]
        if not ok:
            continue

        def col(f):
            return " / ".join(f(r) for r in ok)

        print(f"| {arch} | {shape} | {col(lambda r: f'{r[PEAK] / 2**30:.2f}')} | "
              f"{col(lambda r: f'{r[FLOPS] / 1e12:.1f}')} | "
              f"{col(lambda r: f'{r[WIRE] / 1e9:.1f}')} | "
              f"{col(lambda r: 'yes' if r[PEAK] <= CARD_BYTES else 'no')} |")
    ok = [r for r in rows if r["status"] == "ok"]
    print(f"\n{len(rows)} cells: {len(ok)} ok, "
          f"{sum(r['status'] == 'skipped' for r in rows)} skipped, "
          f"{sum(r['status'] == 'failed' for r in rows)} failed; "
          f"{sum(r[PEAK] <= CARD_BYTES for r in ok)} fit 80 GB")
    for line in other:
        print(f"- {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
