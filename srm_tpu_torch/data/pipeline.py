"""Simulator-output parsing pipeline (Eclipse-style formatted files).

Port of ``srm_tpu/data/pipeline.py``, carried over unchanged so that both
packages parse a deck to the same arrays and share the parsed-results cache
(``output/combined_results.npz``):

* ``.RSM`` tabular summary files with multi-line segmented headers and
  compound column targets like ``["WOPR", "15 15 1"]``
* ``.FINIT`` / ``.FUNRST`` continuous keyword-block files
* Fortran-order reshape with trim/fallback-square logic
* per-directory fan-out (optionally parallel with a process pool),
  stacking across realizations, and npz caching with a JSON stats summary
* the array re-slicing stage (time-index selection and axis merge).

Everything here is host-side numpy in both packages: parsing text is host
work, and no device is involved.
"""

from __future__ import annotations

import json
import logging
import multiprocessing
import os
import re
import uuid
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Target-spec handling
# --------------------------------------------------------------------------
def convert_target_spec(spec) -> Dict[str, Any]:
    """Normalize a target spec list into {key: [phrases]} or nested dicts for
    compound targets like ["WOPR", "15 15 1"]."""
    if isinstance(spec, dict):
        return spec
    out: Dict[str, Any] = {}
    for item in spec:
        if isinstance(item, (list, tuple)):
            key = item[0]
            if len(item) == 1:
                out[key] = [key]
            else:
                sub = " ".join(str(s) for s in item[1:])
                out.setdefault(key, {})[sub] = [key] + [str(s) for s in item[1:]]
        else:
            out[item] = [item]
    return out


def _is_mostly_numbers(line: str, threshold: float = 0.6) -> bool:
    """A data row has one float per (tab-)cell; header rows — mnemonics,
    units, well names, and well-cell labels like ``15 15 1`` — do not."""
    if "\t" in line:
        cells = [c.strip() for c in line.split("\t") if c.strip()]
    else:
        cells = line.split()
    if not cells:
        return False
    numeric = sum(1 for c in cells if _FLOAT.match(c))
    return numeric / len(cells) >= threshold


_FLOAT = re.compile(r"^[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?$")


def _split_segments(text: str) -> List[Tuple[List[str], List[str]]]:
    """Split an .RSM document into ``(header_lines, data_rows)`` segments.

    A segment is a maximal run of non-blank lines (SUMMARY banners are
    dropped); its leading non-numeric lines form the multi-line header and
    the mostly-numeric remainder is the data block.
    """
    blocks: List[List[str]] = []
    cur: List[str] = []
    for raw in text.split("\n") + [""]:
        # keep leading tabs: they are empty cells and removing a variable
        # number of them would shift column alignment between rows
        line = raw.rstrip()
        if line.strip() and not line.strip().upper().startswith("SUMMARY"):
            cur.append(line)
        elif cur:
            blocks.append(cur)
            cur = []
    segments = []
    for block in blocks:
        # drop leading numeric preamble (the ASA "1" page marker printed
        # before each .RSM page banner)
        while block and _is_mostly_numbers(block[0]):
            block = block[1:]
        split = next((k for k, ln in enumerate(block) if _is_mostly_numbers(ln)),
                     len(block))
        header, data = block[:split], [r for r in block[split:]
                                       if _is_mostly_numbers(r)]
        if header and data:
            segments.append((header, data))
    return segments


def _segment_columns(header_lines: List[str],
                     data_rows: List[str]) -> List[Tuple[str, List[float]]]:
    """Column catalog of one segment: ``[(merged header text, values)]``.

    Headers merge vertically per tab-column (mnemonic / unit / well rows
    become one searchable string); data cells parse to float, with NaN for
    unparseable non-empty tokens and *omission* for absent ones (ragged rows
    happen in hand-edited decks).
    """
    head = [ln.split("\t") for ln in header_lines]
    grid = [r.split("\t") for r in data_rows]
    ncol = max(len(r) for r in head + grid)
    catalog = []
    for c in range(ncol):
        text = " ".join(" ".join(r[c].split())
                        for r in head if c < len(r) and r[c].strip())
        vals: List[float] = []
        for r in grid:
            tok = r[c].strip() if c < len(r) else ""
            if tok:
                vals.append(float(tok) if _FLOAT.match(tok) else float("nan"))
        catalog.append((" ".join(text.split()), vals))
    return catalog


def parse_tabular_file(data_str: str, target_spec, dtype=np.float32) -> Dict[str, Any]:
    """Parse a segmented .RSM-style summary table.

    Column-major (``srm_tpu/data/pipeline.py:127-167``): each segment is
    reduced to a header→column catalog first and the targets
    are then matched against the catalog (first column whose merged header
    contains every phrase wins); series spanning several segments
    concatenate in document order.  Golden fixtures:
    ``tests/golden/sample.RSM``.
    """
    targets = convert_target_spec(target_spec)
    acc: Dict[str, Any] = {
        k: ({sk: [] for sk in v} if isinstance(v, dict) else [])
        for k, v in targets.items()
    }

    def first_match(catalog, phrases) -> Optional[List[float]]:
        ph = [" ".join(str(p).split()) for p in phrases]
        return next((vals for text, vals in catalog
                     if all(p in text for p in ph)), None)

    for header_lines, data_rows in _split_segments(data_str):
        catalog = _segment_columns(header_lines, data_rows)
        for key, spec in targets.items():
            if isinstance(spec, dict):
                for sub, phrases in spec.items():
                    vals = first_match(catalog, phrases)
                    if vals is not None:
                        acc[key][sub].extend(vals)
            else:
                vals = first_match(catalog, spec)
                if vals is not None:
                    acc[key].extend(vals)

    def finalize(v):
        return np.asarray(v, dtype) if v else None

    return {k: ({sk: finalize(sv) for sk, sv in v.items()}
                if isinstance(v, dict) else finalize(v))
            for k, v in acc.items()}


def parse_continuous_file(content: str, target_keys: Sequence[str],
                          dtype=np.float32) -> Dict[str, List[np.ndarray]]:
    """Parse a keyword-block file (.FINIT/.FUNRST).

    Blocks start with a quoted keyword line; following numeric lines belong to
    the current keyword until a blank line or next keyword.
    """
    data: Dict[str, List[np.ndarray]] = {k: [] for k in target_keys}
    cur_key, cur_block = None, []

    def flush():
        if cur_key in data and cur_block:
            data[cur_key].append(np.asarray(cur_block, dtype))

    for line in content.splitlines():
        s = line.strip()
        if s.startswith("'"):
            flush()
            parts = s.split("'")
            cur_key = parts[1].strip() if len(parts) > 1 else None
            cur_block = []
        elif s == "":
            flush()
            cur_key, cur_block = None, []
        elif cur_key in data:
            try:
                cur_block.extend(float(x) for x in s.split())
            except ValueError:
                pass
    flush()
    return data


def reshape_array(arr: np.ndarray, shape: Optional[Tuple[int, ...]],
                  order: str = "F") -> np.ndarray:
    """Fortran-order reshape with trim / fallback-square logic."""
    if shape is None:
        return arr
    want = int(np.prod(shape))
    flat = arr.reshape(-1)
    if flat.size == want:
        return flat.reshape(shape, order=order)
    if flat.size > want and flat.size % want == 0:
        return flat[: (flat.size // want) * want].reshape((-1,) + tuple(shape), order=order)
    if flat.size > want:
        return flat[:want].reshape(shape, order=order)
    side = int(np.sqrt(flat.size))
    if side * side == flat.size:
        return flat.reshape((side, side), order=order)
    return flat


# --------------------------------------------------------------------------
# Per-directory fan-out
# --------------------------------------------------------------------------
def process_file_sim(path: str, file_vectors: Dict[str, Any],
                     shape: Optional[Tuple[int, ...]] = None, dtype=np.float32):
    """Parse one simulator file according to its extension's target vector."""
    ext = os.path.splitext(path)[1].upper()
    spec = file_vectors.get(ext) or file_vectors.get(ext.lower())
    if spec is None:
        return None
    with open(path, errors="ignore") as f:
        content = f.read()
    if ext == ".RSM":
        return parse_tabular_file(content, spec, dtype)
    parsed = parse_continuous_file(content, [s if isinstance(s, str) else s[0] for s in spec], dtype)
    out = {}
    for k, blocks in parsed.items():
        if not blocks:
            continue
        arrs = [reshape_array(b, shape) for b in blocks]
        out[k] = np.stack(arrs, axis=0) if len(arrs) > 1 else arrs[0][None]
    return out


def process_files_in_directory(directory: str, file_vectors: Dict[str, Any],
                               shape=None, parallel: bool = False, max_workers: int = 4,
                               dtype=np.float32) -> Dict[str, Dict[str, np.ndarray]]:
    """Parse every matching file in a directory, optionally with a process
    pool."""
    exts = {e.upper() for e in file_vectors}
    files = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if os.path.splitext(f)[1].upper() in exts
    )
    results: Dict[str, Dict[str, np.ndarray]] = {}
    if parallel and len(files) > 1:
        # spawned workers, not forked ones: a fork of a process that has
        # initialised CUDA is unsafe, and a spawned worker imports this
        # module alone (numpy, no torch). parallel=False stays the default.
        with ProcessPoolExecutor(max_workers=max_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = {pool.submit(process_file_sim, p, file_vectors, shape, dtype): p for p in files}
            for fut, p in futures.items():
                try:
                    r = fut.result()
                    if r:
                        results[os.path.basename(p)] = r
                except Exception as e:  # one failed file is logged, the rest parsed
                    log.error("Failed to parse %s: %s", p, e)
    else:
        for p in files:
            try:
                r = process_file_sim(p, file_vectors, shape, dtype)
                if r:
                    results[os.path.basename(p)] = r
            except Exception as e:
                log.error("Failed to parse %s: %s", p, e)
    return results


def stack_realizations(per_file: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack equally-keyed arrays across realizations."""
    keys: Dict[str, List[np.ndarray]] = {}
    for fname in sorted(per_file):
        for k, v in per_file[fname].items():
            if isinstance(v, np.ndarray):
                keys.setdefault(k, []).append(v)
    return {k: np.stack(v, axis=0) for k, v in keys.items() if v}


def private_name(path: str, suffix: str = "") -> str:
    """A temporary name beside ``path`` that no other process writes:
    processes that build one file at once each publish a whole file with
    ``os.replace``, the last one winning."""
    return f"{path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp{suffix}"


def save_results(results: Dict[str, np.ndarray], output_folder: str,
                 combined_filename: str = "combined_results.npz") -> str:
    """Save combined npz + per-key stats summary.json."""
    os.makedirs(output_folder, exist_ok=True)
    path = os.path.join(output_folder, combined_filename)
    # atomic publish (a killed writer must not leave a truncated npz), from
    # a name of this process's own (processes parsing one directory at once
    # each publish a whole file)
    tmp = private_name(path, ".npz")
    np.savez_compressed(tmp, **results)
    os.replace(tmp, path)
    summary = {k: {"shape": list(v.shape), "min": float(np.nanmin(v)), "max": float(np.nanmax(v)),
                   "mean": float(np.nanmean(v)), "std": float(np.nanstd(v))}
               for k, v in results.items()}
    summary_path = os.path.join(output_folder, "summary.json")
    tmp = private_name(summary_path)
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(tmp, summary_path)
    return path


def run_pipeline_for_directory(directory: str, shape=(39, 39, 1), keys=("PRESSURE", "SGAS"),
                               parallel: bool = False, max_workers: int = 4,
                               combined_filename: str = "combined_results.npz",
                               file_vectors: Optional[Dict] = None) -> Optional[Dict[str, np.ndarray]]:
    """Parse (or load cached) simulator outputs for one dynamic directory and
    return {key: (realizations, time, *grid)} arrays limited to ``keys``."""
    output_folder = os.path.join(directory, "output")
    cached = os.path.join(output_folder, combined_filename)
    if os.path.isfile(cached):
        with np.load(cached) as z:
            data = {k: z[k] for k in z.files}
    else:
        fv = file_vectors or {
            ".FINIT": ["PERMX", "PERMZ", "PORO"],
            ".FUNRST": ["PRESSURE", "SOIL", "SGAS"],
            ".RSM": [["TIME"], "WGPR", "WBHP"],
        }
        per_file = process_files_in_directory(directory, fv, shape, parallel, max_workers)
        if not per_file:
            return None
        data = stack_realizations(per_file)
        save_results(data, output_folder, combined_filename)
    out = {k: v for k, v in data.items() if k in keys}
    return out or None


# --------------------------------------------------------------------------
# Array re-slicing stage
# --------------------------------------------------------------------------
def process_array(array, slices: Optional[Sequence[int]] = None, slice_dim: int = 1,
                  reshape_dims: Optional[Tuple[int, ...]] = (0, 1),
                  dtype=np.float32) -> np.ndarray:
    """Select time indices along ``slice_dim`` and merge the ``reshape_dims``
    axes into one (the post-parse re-slicing stage: np.take + axis merge)."""
    arr = np.asarray(array, dtype=dtype)
    if slices is not None and len(slices) > 0:
        arr = np.take(arr, indices=list(slices), axis=slice_dim)
    if reshape_dims:
        axes = sorted(set(d % arr.ndim for d in reshape_dims))
        if len(axes) > 1:
            if axes != list(range(axes[0], axes[-1] + 1)):
                raise ValueError(f"reshape_dims must be contiguous, got {reshape_dims}")
            shape = list(arr.shape)
            merged = int(np.prod([shape[a] for a in axes]))
            new_shape = shape[: axes[0]] + [merged] + shape[axes[-1] + 1:]
            arr = arr.reshape(new_shape)
    return arr


def process_file_data(file_path: str, keys: Sequence[str] = ("PRESSURE", "SGAS"),
                      exclusions: Sequence[str] = ("PERMX", "PERMY", "PERMZ", "PORO"),
                      slices=None, slice_dim: int = 1,
                      reshape_dims: Optional[Tuple[int, ...]] = (0, 1),
                      dtype=np.float32) -> Dict[str, np.ndarray]:
    """Apply :func:`process_array` to selected keys of an .npz/.json file."""
    if file_path.endswith(".json"):
        with open(file_path) as f:
            data = {k: np.asarray(v) for k, v in json.load(f).items()}
    else:
        with np.load(file_path, allow_pickle=True) as z:
            data = {k: z[k] for k in z.files}
    out: Dict[str, np.ndarray] = {}
    for key in keys:
        if key not in data:
            log.info("Key %r not found in %s — skipping.", key, file_path)
            continue
        if key in exclusions:
            log.info("Key %r is excluded — skipping.", key)
            continue
        out[key] = process_array(data[key], slices=slices, slice_dim=slice_dim,
                                 reshape_dims=reshape_dims, dtype=dtype)
    return out


def run_array_pipeline(config: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Config-driven re-slicing over a parsed-results file:
    pick the combined npz (or a named file) from ``directory``, select time
    indices with ``slices`` along ``slice_dim``, and merge ``reshape_dims``."""
    directory = config["directory"]
    ext = config.get("ext", ".npz")
    file_name = config.get("file")
    if file_name:
        file_path = os.path.join(directory, file_name)
    else:
        cands = sorted(f for f in os.listdir(directory) if f.endswith(ext))
        if not cands:
            raise FileNotFoundError(f"No {ext} file in {directory}")
        file_path = os.path.join(directory, cands[0])
    out = process_file_data(
        file_path,
        keys=config.get("keys", ("PRESSURE", "SGAS")),
        exclusions=config.get("exclusions", ("PERMX", "PERMY", "PERMZ", "PORO")),
        slices=config.get("slices"), slice_dim=config.get("slice_dim", 1),
        reshape_dims=tuple(config["reshape_dims"]) if config.get("reshape_dims") else None,
        dtype=config.get("dtype", np.float32))
    if not out:
        raise ValueError(f"No arrays processed from {file_path}")
    return out


def run_pipeline_from_config(config: Dict[str, Any]) -> Optional[Dict[str, np.ndarray]]:
    """Config-driven orchestrator."""
    sim = config.get("simulation_pipeline", {})
    if not sim.get("enabled", False):
        output_folder = sim.get("output_folder")
        if output_folder:
            cached = os.path.join(output_folder, sim.get("combined_filename", "combined_results.npz"))
            if os.path.isfile(cached):
                with np.load(cached) as z:
                    return {k: z[k] for k in z.files}
        return None
    ap = config.get("array_pipeline", {}) or {}
    data = run_pipeline_for_directory(
        sim["input_folder"], shape=sim.get("shape"),
        keys=tuple(ap.get("keys", ("PRESSURE", "SGAS"))),
        parallel=sim.get("parallel", False), max_workers=sim.get("max_workers", 4),
        combined_filename=sim.get("combined_filename", "combined_results.npz"),
        file_vectors=sim.get("file_vectors"),
    )
    if data is None:
        return None
    # optional re-slicing stage (time-index selection + axis merge)
    if ap.get("slices") is not None or ap.get("reshape_dims"):
        data = {k: process_array(v, slices=ap.get("slices"),
                                 slice_dim=ap.get("slice_dim", 1),
                                 reshape_dims=(tuple(ap["reshape_dims"])
                                               if ap.get("reshape_dims") else None))
                for k, v in data.items()}
    return data
