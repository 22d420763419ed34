"""Batch runner, manifest-based (twin of ``hcunet_tpu/apps/batch.py``; the
reference's ``loop_main.py`` role).

The reference walks ``**/**/*.tif`` under a data root and guards each image
with ``analysis.lock`` (done: skip) and ``error.lock`` (failed: record and
continue) files (``loop_main.py:31-66``).  Here the same idempotency is a
JSON manifest per image directory plus the per-chunk journal the pipeline
keeps, so a partly analyzed image resumes mid-chunk rather than
restarting.  The manifest format is the JAX package's.
"""

from __future__ import annotations

import glob
import json
import os
import time
import traceback
from typing import Callable, List, Optional

from hcunet_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MANIFEST = "analysis_manifest.json"


def _manifest_path(out_dir: str) -> str:
    return os.path.join(out_dir, MANIFEST)


def read_status(out_dir: str) -> dict:
    p = _manifest_path(out_dir)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def write_status(out_dir: str, **kv) -> None:
    status = read_status(out_dir)
    status.update(kv, updated=time.strftime("%Y-%m-%d %H:%M:%S"))
    with open(_manifest_path(out_dir), "w") as f:
        json.dump(status, f, indent=2)


def host_shard() -> tuple[int, int]:
    """(index, count) of this process in a multi-process job.

    ``torch.distributed``'s rank and world size when a process group is
    initialised with more than one process (where the JAX package reads
    ``jax.process_index``/``jax.process_count``), else the environment
    variables ``HCUNET_SHARD_INDEX`` / ``HCUNET_SHARD_COUNT``, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return (
        int(os.environ.get("HCUNET_SHARD_INDEX", 0)),
        int(os.environ.get("HCUNET_SHARD_COUNT", 1)),
    )


def run_batch(
    data_root: str,
    analyze_fn: Callable[[str, str], object],
    pattern: str = "**/*.tif",
    retry_errors: bool = False,
    shard: Optional[tuple[int, int]] = None,
) -> List[dict]:
    """For each image under ``data_root``: create ``<name>_cellBycell/``,
    skip it if its manifest says done (or error, unless ``retry_errors``),
    run ``analyze_fn(image_path, out_dir)``, record success or failure, and
    continue on error (``loop_main.py:47-66``).

    ``shard=(i, n)`` statically partitions the sorted image list across
    processes (``images[i::n]``); it defaults to :func:`host_shard`."""
    images = sorted(glob.glob(os.path.join(data_root, pattern), recursive=True))
    images = [p for p in images if "_cellBycell" not in p]
    idx, count = shard if shard is not None else host_shard()
    if count > 1:
        images = images[idx::count]
    results = []
    for img_path in images:
        out_dir = os.path.splitext(img_path)[0] + "_cellBycell"
        os.makedirs(out_dir, exist_ok=True)
        status = read_status(out_dir)
        if status.get("state") == "done":
            log.info("skip (done): %s", img_path)
            results.append({"image": img_path, "state": "done", "cached": True})
            continue
        if status.get("state") == "error" and not retry_errors:
            log.info("skip (previous error): %s", img_path)
            results.append({"image": img_path, "state": "error", "cached": True})
            continue
        log.info("analyzing %s", img_path)
        write_status(out_dir, state="running", image=img_path)
        t0 = time.perf_counter()
        try:
            analyze_fn(img_path, out_dir)
            write_status(
                out_dir, state="done", seconds=round(time.perf_counter() - t0, 1)
            )
            results.append({"image": img_path, "state": "done"})
        except Exception as e:  # noqa: BLE001 — a batch survives any one image's failure
            write_status(
                out_dir, state="error", error=str(e),
                traceback=traceback.format_exc(),
            )
            log.error("failed %s: %s", img_path, e)
            results.append({"image": img_path, "state": "error", "error": str(e)})
    return results
