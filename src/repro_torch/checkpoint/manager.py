"""Checkpointing: atomic, asynchronous, keep-k, verified (counterpart of
`repro.checkpoint.manager`), in the reference's on-disk format.

Layout (one directory per step):

    <root>/step_00000400.tmp/...    while writing
    <root>/step_00000400/
        manifest.json               leaf paths, shapes, dtypes, crc32s, extras
        manifest.crc32              crc32 of the manifest bytes (text)
        arrays/<leaf-path>.npy      one file per leaf, "/" in the path as "__"

Writes go to a .tmp directory first and are renamed into place, so a crash
mid-save never corrupts the latest checkpoint; restore picks the newest
complete directory. `save(..., blocking=False)` copies every leaf to host
memory before it returns (the training step then overwrites the live
buffers in place) and hands the checksums and file IO to a worker thread. A
failure on that worker is captured and re-raised from `wait()` or the next
`save()`, never swallowed: `run_resilient` spends a restart on it.

Integrity: every leaf record carries the crc32 of its array bytes and the
manifest is checksummed into a sibling file. `restore` verifies leaf crcs
while loading and falls back to the newest verified older step when a
checkpoint is corrupted or truncated; `all_steps` skips directories that
fail the manifest-level check. Checkpoints without checksums (written before
the reference had them) restore unchanged.

Leaves and their paths are the reference's (`repro.utils.trees.tree_paths`
of the reference's state), so a checkpoint written by either package
restores in the other:
* a state is walked as the reference flattens it: NamedTuple fields in order,
  tuples by index, mappings by sorted key; a `BucketedState` is written in
  its per-leaf form (`buckets.to_portable`), one host copy per buffer;
* a port parameter name is its path in the reference's tree, and the
  per-block leaves of a name ("blocks.<i>.attn.wq", i = 0..L-1) are one
  stacked (L, ...) leaf "blocks/attn/wq", as the reference stacks its blocks
  (contiguous in a bucket, so stacking a resident state copies nothing):
  `models.convert`'s mapping, which the ascent wire uses too;
* host values are 0-d arrays: a bool as bool, an int as int32 (the
  reference's step and staleness; int64 when it does not fit);
* bf16 leaves are written as the reference writes them (numpy's descr
  "<V2", raw 2-byte records, dtype "bfloat16" in the manifest, the crc over
  those bytes) and read back by the manifest's dtype, as uint16 bits viewed
  as torch.bfloat16: numpy has no bfloat16.
The reference's TrainState.rng is a PRNG key (uint32[2]) where the port's is
an int seed, so that one leaf does not cross between the packages.

Restore places tensors on the device of the matching tensor of `like`, or
on `device` when given (`run_resilient` restores to the host and copies into
the live buffers, `buckets.residentize(..., like=state)`).

Sharded state (DTensor leaves, `engine.fused` on a mesh of ranks): a save
gathers each leaf to its full tensor (a collective on the leaf's mesh, so
every rank of the world calls `save` at the same step, as `run_resilient`
does), rank 0 alone writes the reference's format, blocking, and every rank
waits at a barrier until it is on disk. A restore reads the full arrays on
every rank and re-places each leaf onto the current mesh: by `shardings`
(`runtime.elastic.state_shardings`) when given, else as the matching leaf
of `like` lies. So a checkpoint written on 8 ranks restores onto 4, or into
a 1-device (bucket-resident) fit.
"""
from __future__ import annotations

import json
import logging
import pathlib
import re
import shutil
import threading
import zlib
from typing import Any, Iterator, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.models import convert
from repro_torch.utils import buckets, distributed

log = logging.getLogger("repro_torch.checkpoint")

Tree = Any
_STEP_RE = re.compile(r"step_(\d+)$")
_BF16_DESCR = "<V2"          # numpy's descr of an ml_dtypes bfloat16 array


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint directory failed crc32/structure verification."""


def _leaf_crc(arr: np.ndarray) -> int:
    """zlib.crc32 of the array's bytes, as the reference's
    `zlib.crc32(arr.tobytes())`, without a second copy of the array."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).data)


# ---------------------------------------------------------------------------
# Walking a state in the reference's flatten order
# ---------------------------------------------------------------------------

def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def _host(x) -> Union[torch.Tensor, np.ndarray]:
    """A leaf as a host value the caller may keep: tensors are copied off the
    device (a CPU tensor too: the step writes its state in place)."""
    if isinstance(x, torch.Tensor):
        return distributed.gather(x.detach()).to("cpu", copy=True)
    if isinstance(x, (bool, np.bool_)):
        return np.asarray(bool(x))
    if isinstance(x, (int, np.integer)):
        return np.asarray(int(x), np.int32 if -2**31 <= int(x) < 2**31 else np.int64)
    if isinstance(x, np.ndarray):
        return x.copy()
    raise TypeError(f"checkpoint leaf of type {type(x).__name__}")


def _host_leaves(tree: Tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, host array or tensor) of every leaf of `tree`."""
    if buckets.is_bucketed(tree):
        host = buckets.BucketedState(tuple(_host(b) for b in tree.buffers), tree.layout)
        yield from _mapping_leaves(host.to_tree(), prefix, copy=False)
    elif isinstance(tree, Mapping):
        yield from _mapping_leaves(tree, prefix, copy=True)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _host_leaves(v, _join(prefix, name))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _host_leaves(v, _join(prefix, str(i)))
    else:
        yield prefix, _host(tree)


def _mapping_leaves(mapping: Mapping, prefix: str, copy: bool):
    """`copy` False: the mapping's tensors are host copies already (a
    bucket's views), yielded as they are."""
    for path, keys, stacked in convert.reference_groups(mapping):
        full, vals = _join(prefix, path), [mapping[k] for k in keys]
        if not stacked:
            if copy or not isinstance(vals[0], torch.Tensor):
                yield from _host_leaves(vals[0], full)
            else:
                yield full, vals[0]
            continue
        yield full, convert.stack_blocks([_host(v) for v in vals] if copy else vals)


def _tensors(tree: Tree) -> Iterator[torch.Tensor]:
    """Every tensor of `tree` (a BucketedState's buffers included)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif buckets.is_bucketed(tree):
        yield from tree.buffers
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """(array, the reference's dtype name); bf16 as its uint16 bits."""
    if isinstance(x, np.ndarray):
        return x, str(x.dtype)
    if x.dtype == torch.bfloat16:
        return x.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = x.contiguous().numpy()
    return arr, str(arr.dtype)


def _write_leaf(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:       # np.save of an ml_dtypes bfloat16 array
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).data)


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded array (C-contiguous, as np.load gives it) as a tensor."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _tree_finite(tree: Tree) -> bool:
    """True iff every float tensor of `tree` is finite."""
    if isinstance(tree, torch.Tensor):
        return not tree.is_floating_point() or bool(torch.isfinite(tree).all())
    if isinstance(tree, Mapping):
        return all(_tree_finite(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return all(_tree_finite(v) for v in tree)
    return True


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    def __init__(self, root: Union[str, pathlib.Path], keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._worker: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Tree, extras: Optional[dict] = None,
             blocking: bool = True) -> pathlib.Path:
        """Snapshot `state` at `step`. Every leaf is on the host when this
        returns, so the caller may update its tensors in place.

        Re-raises a failure from a previous non-blocking save first: the
        caller must not keep training believing checkpoints exist.
        """
        self.wait()
        sharded = any(map(distributed.is_dtensor, _tensors(state)))
        leaves = [(path, *_to_numpy(x)) for path, x in _host_leaves(state)]
        final = self.root / f"step_{step:08d}"
        if sharded:
            # every rank gathered; rank 0 writes, and no rank goes on before
            # the checkpoint is on disk
            if distributed.rank() == 0:
                self._write(leaves, step, extras, final)
            distributed.barrier()
            return final

        def write():
            self._write(leaves, step, extras, final)

        if blocking:
            write()
        else:
            def guarded():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 (re-raised by wait/save)
                    self._async_error = e
            self._worker = threading.Thread(target=guarded, daemon=True)
            self._worker.start()
        return final

    def _write(self, leaves: list, step: int, extras: Optional[dict],
               final: pathlib.Path) -> None:
        tmp = self.root / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)
        manifest = {"step": step, "extras": extras or {}, "leaves": []}
        for path, arr, dtype in leaves:
            fname = path.replace("/", "__") + ".npy"
            _write_leaf(tmp / "arrays" / fname, arr, dtype)
            manifest["leaves"].append({"path": path, "file": fname,
                                       "shape": list(arr.shape), "dtype": dtype,
                                       "crc32": _leaf_crc(arr)})
        manifest_bytes = json.dumps(manifest).encode()
        (tmp / "manifest.json").write_bytes(manifest_bytes)
        # the manifest's own checksum lives in a sibling file
        (tmp / "manifest.crc32").write_text(str(zlib.crc32(manifest_bytes)))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def wait(self) -> None:
        """Join any in-flight async save; re-raise its failure (once)."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise RuntimeError(
                f"async checkpoint save failed: {type(err).__name__}: {err}") from err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- verification
    def _verify_manifest(self, d: pathlib.Path) -> Optional[dict]:
        """Manifest parses, matches its sibling checksum (when there is one),
        and every leaf file exists. Returns the manifest, or None."""
        try:
            manifest_bytes = (d / "manifest.json").read_bytes()
            crc_file = d / "manifest.crc32"
            if crc_file.exists() and int(crc_file.read_text()) != zlib.crc32(manifest_bytes):
                return None
            manifest = json.loads(manifest_bytes)
            for rec in manifest["leaves"]:
                if not (d / "arrays" / rec["file"]).is_file():
                    return None
            return manifest
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def verify_step(self, step: int, deep: bool = True) -> bool:
        """Full verification of one step: manifest + (deep) per-leaf crc32."""
        d = self.root / f"step_{step:08d}"
        manifest = self._verify_manifest(d)
        if manifest is None:
            return False
        if not deep:
            return True
        for rec in manifest["leaves"]:
            try:
                arr = np.load(d / "arrays" / rec["file"])
            except (OSError, ValueError):
                return False
            if "crc32" in rec and _leaf_crc(arr) != rec["crc32"]:
                return False
        return True

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        """Steps with a structurally verified checkpoint directory."""
        out = []
        for p in self.root.iterdir():
            m = _STEP_RE.search(p.name)
            if m and p.is_dir() and self._verify_manifest(p) is not None:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_step(self, step: int, like: Tree, device: Optional[torch.device],
                   shardings: Tree = None) -> tuple[Tree, dict]:
        """Load one step into `like`'s structure, crc-checking every leaf as it
        is read; CheckpointIntegrityError on any mismatch or corruption."""
        d = self.root / f"step_{step:08d}"
        manifest = self._verify_manifest(d)
        if manifest is None:
            raise CheckpointIntegrityError(f"{d}: manifest failed verification")
        by_path = {rec["path"]: rec for rec in manifest["leaves"]}

        def load(path: str, shape: tuple) -> tuple[np.ndarray, str]:
            rec = by_path.get(path)
            if rec is None:
                raise ValueError(f"{d}: checkpoint has no leaf {path}")
            try:
                arr = np.load(d / "arrays" / rec["file"])
            except (OSError, ValueError) as e:
                raise CheckpointIntegrityError(f"{d}: leaf {path} unreadable ({e})") from e
            if "crc32" in rec and _leaf_crc(arr) != rec["crc32"]:
                raise CheckpointIntegrityError(
                    f"{d}: leaf {path} crc32 mismatch (corrupted data)")
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{path}: ckpt {arr.shape} vs model {tuple(shape)}")
            return arr, rec["dtype"]

        def tensor(leaf: torch.Tensor, t: torch.Tensor, sh) -> torch.Tensor:
            """The loaded full tensor `t` placed as the live `leaf` is, or
            by its LeafSharding `sh`."""
            t = t.to(leaf.dtype)
            if sh is not None and hasattr(sh, "placements"):
                from repro_torch.runtime.elastic import place_leaf
                return place_leaf(t, sh.mesh, sh.placements)
            if distributed.is_dtensor(leaf):
                return distributed.place_like(t, leaf)
            return t.to(device if device is not None else leaf.device)

        def sub(sh, key):
            return None if sh is None or hasattr(sh, "placements") else sh[key]

        def build(tree: Tree, prefix: str, sh=None) -> Tree:
            if buckets.is_bucketed(tree):
                return build(tree.to_tree(), prefix)
            if isinstance(tree, Mapping):
                out = {}
                for path, keys, stacked in convert.reference_groups(tree):
                    full = _join(prefix, path)
                    if not stacked:
                        out[keys[0]] = build(tree[keys[0]], full, sub(sh, keys[0]))
                        continue
                    first = tree[keys[0]]
                    arr, dtype = load(full, (len(keys), *first.shape))
                    blocks = _as_tensor(arr, dtype).unbind(0)
                    out.update((k, tensor(tree[k], b, sub(sh, k))) for k, b in zip(keys, blocks))
                return {k: out[k] for k in tree}
            if isinstance(tree, tuple) and hasattr(tree, "_fields"):
                return type(tree)(*(build(v, _join(prefix, n), sub(sh, i))
                                    for i, (n, v) in enumerate(zip(tree._fields, tree))))
            if isinstance(tree, (tuple, list)):
                return type(tree)(build(v, _join(prefix, str(i)), sub(sh, i))
                                  for i, v in enumerate(tree))
            if isinstance(tree, torch.Tensor):
                arr, dtype = load(prefix, tuple(tree.shape))
                return tensor(tree, _as_tensor(arr, dtype), sh)
            if isinstance(tree, (bool, int, np.integer, np.bool_)):
                arr, _ = load(prefix, ())
                return type(tree)(arr.item())
            raise TypeError(f"checkpoint leaf {prefix} of type {type(tree).__name__}")

        return build(like, "", shardings), manifest["extras"]

    def restore(self, like: Tree, step: Optional[int] = None, *,
                device: Optional[Union[str, torch.device]] = None,
                require_finite: bool = False,
                shardings: Tree = None) -> tuple[Tree, dict]:
        """Restore into the structure of `like` (a state, or any tree of the
        same structure; BucketedState nodes come back in portable form).
        Returns (state, extras). `shardings` (`runtime.elastic.
        state_shardings` of the state on the current mesh) places each leaf
        on that mesh; without it a leaf is placed as like's is.

        A corrupted or truncated checkpoint falls back to the newest verified
        older step; only when every candidate fails does this raise.
        `require_finite` extends the fallback to a checkpoint whose float
        leaves hold NaN/Inf.
        """
        candidates = [s for s in self.all_steps() if step is None or s <= step]
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {self.root}"
                                    + (f" at or before step {step}" if step is not None else ""))
        device = torch.device(device) if device is not None else None
        last_err: Optional[Exception] = None
        for s in reversed(candidates):
            try:
                state, extras = self._load_step(s, like, device, shardings)
            except CheckpointIntegrityError as e:
                log.warning("checkpoint step %d failed verification (%s); "
                            "falling back to an older step", s, e)
                last_err = e
                continue
            if require_finite and not _tree_finite(state):
                log.warning("checkpoint step %d holds non-finite values; "
                            "falling back to an older step", s)
                last_err = CheckpointIntegrityError(f"step {s}: non-finite leaf values")
                continue
            return state, extras
        raise CheckpointIntegrityError(
            f"no verifiable checkpoint under {self.root}") from last_err
