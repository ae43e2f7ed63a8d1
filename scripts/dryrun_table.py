#!/usr/bin/env python3
"""The dry run's records as one markdown table, or two runs' records side by
side.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --device cpu
    python3 scripts/dryrun_table.py [artifacts/dryrun_torch]
    python3 scripts/dryrun_table.py AFTER_DIR --before BEFORE_DIR

One row an (arch, shape) of the untagged records, with each mesh's rank-0
peak live bytes in GiB, flops (in TFLOP) and collectives' wire bytes (the
reference's ring model, in GB), and whether each peak fits one 80 GB card
(peak <= 80e9 bytes); skipped and failed cells are listed under it. With
`--before`, one row an (arch, shape) whose peak, flops or wire bytes differ
between the two folders on a mesh, each as before -> after (fits: "yn" is
yes before, no after), then the count of cells that fit a card in each, the
cells whose status changed and those whose peak rose by more than 5%.
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


def records(folder: pathlib.Path) -> list[dict]:
    """The untagged records of a folder, by arch, shape and mesh."""
    rows = []
    for path in sorted(folder.glob("*.json")):
        rec = json.loads(path.read_text())
        if path.stem != f"{rec['arch']}_{rec['shape']}_{rec['mesh']}":
            continue                                   # a tagged record
        rows.append(rec)
    rows.sort(key=lambda r: (r["arch"], SHAPES.index(r["shape"]), MESHES.index(r["mesh"])))
    return rows


def fits(rows: list[dict]) -> int:
    return sum(r["status"] == "ok" and r[PEAK] <= CARD_BYTES for r in rows)


def compare(after: list[dict], before: list[dict]) -> None:
    was = {(r["arch"], r["shape"], r["mesh"]): r for r in before}
    cells: dict = {}
    moved, risen = [], []
    for r in after:
        b = was.get((r["arch"], r["shape"], r["mesh"]))
        if b is None or b["status"] != r["status"]:
            moved.append(f"{r['arch']} {r['shape']} {r['mesh']}: "
                         f"{b['status'] if b else 'absent'} -> {r['status']}")
        elif r["status"] == "ok" and any(r[k] != b[k] for k in (PEAK, FLOPS, WIRE)):
            cells.setdefault((r["arch"], r["shape"]), []).append((b, r))
            if r[PEAK] > 1.05 * b[PEAK]:
                risen.append(f"{r['arch']} {r['shape']} {r['mesh']}")
    print("| Arch | Shape | Peak GiB 16x16 / 2x16x16 | TFLOP | Collective GB | Fits 80 GB |")
    print("| --- | --- | --- | --- | --- | --- |")
    for (arch, shape), pairs in cells.items():
        def col(k, scale, fmt):
            return " / ".join(f"{format(b[k] / scale, fmt)} -> {format(r[k] / scale, fmt)}"
                              for b, r in pairs)

        fit = " / ".join("".join("y" if x[PEAK] <= CARD_BYTES else "n" for x in pair)
                         for pair in pairs)
        print(f"| {arch} | {shape} | {col(PEAK, 2**30, '.2f')} | {col(FLOPS, 1e12, '.1f')} | "
              f"{col(WIRE, 1e9, '.1f')} | {fit} |")
    print(f"\nfit 80 GB: {fits(before)} of {len(before)} cells before, "
          f"{fits(after)} of {len(after)} after")
    print(f"status changed: {moved or 'none'}; peak up more than 5%: {risen or 'none'}")


def main() -> int:
    args = sys.argv[1:]
    before = None
    if "--before" in args:
        i = args.index("--before")
        before, args = pathlib.Path(args[i + 1]), args[:i] + args[i + 2:]
    folder = pathlib.Path(args[0]) if args else ROOT / "artifacts" / "dryrun_torch"
    rows = records(folder)
    if before is not None:
        compare(rows, records(before))
        return 0
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
          f"{fits(rows)} fit 80 GB")
    for line in other:
        print(f"- {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
