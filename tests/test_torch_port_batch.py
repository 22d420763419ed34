"""The port's batch runner (``hcunet_tpu_torch/apps/batch.py``) against the
JAX package's ``hcunet_tpu/apps/batch.py``: the manifest file and its
states, the skip and retry rules, a failing image recorded and survived,
the static ``shard=(i, n)`` partition from the argument, the environment
and, in two processes, ``torch.distributed`` (the twin of
``tests/test_batch_dcn.py``, on gloo)."""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np

from hcunet_tpu.apps import batch as jbatch
from hcunet_tpu_torch.apps import batch as tbatch
from hcunet_tpu_torch.data.tiff import imwrite

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root(path, names):
    path.mkdir(exist_ok=True)
    for name in names:
        imwrite(str(path / name), np.zeros((2, 4, 4), np.uint8))
    return path


def _run_both(tmp_path, names, analyze_fn, **kw):
    """``run_batch`` of both packages over the two copies of one data root
    under ``tmp_path``; the results with the root cut from the image paths,
    and the manifests."""
    out = []
    for name, mod in (("jax", jbatch), ("port", tbatch)):
        root = tmp_path / name
        res = mod.run_batch(str(root), analyze_fn, **kw)
        for r in res:
            r["image"] = os.path.relpath(r["image"], root)
        manifests = {
            n: {k: v for k, v in mod.read_status(str(root / (n[:-4] + "_cellBycell"))).items()
                if k not in ("updated", "seconds", "traceback", "image")}
            for n in names
        }
        out.append((res, manifests))
    return out


def test_batch_manifest_matches_jax(tmp_path):
    calls = []

    def fake_analyze(img, out):
        calls.append(os.path.basename(img))
        assert os.path.isdir(out) and out.endswith("_cellBycell")
        if img.endswith("b.tif"):
            raise RuntimeError("synthetic failure")

    names = ["a.tif", "b.tif", "sub/c.tif"]
    for side in ("jax", "port"):
        (tmp_path / side / "sub").mkdir(parents=True)
        _root(tmp_path / side, names)

    (j, jm), (t, tm) = _run_both(tmp_path, names, fake_analyze)
    assert t == j and tm == jm
    assert {r["image"]: r["state"] for r in t} == {
        "a.tif": "done", "b.tif": "error", os.path.join("sub", "c.tif"): "done",
    }
    assert tm["b.tif"] == {"state": "error", "error": "synthetic failure"}
    assert sorted(calls) == sorted(["a.tif", "b.tif", "c.tif"] * 2)

    # second pass: both skip everything (done + the recorded error)
    calls.clear()
    (j, jm), (t, tm) = _run_both(tmp_path, names, fake_analyze)
    assert calls == [] and t == j and all(r["cached"] for r in t)

    # retry_errors reruns the failed image only, which fails again
    (j, jm), (t, tm) = _run_both(tmp_path, names, fake_analyze, retry_errors=True)
    assert calls == ["b.tif", "b.tif"] and t == j and tm == jm
    status = tbatch.read_status(str(tmp_path / "port" / "b_cellBycell"))
    assert status["state"] == "error" and "RuntimeError: synthetic failure" in status["traceback"]
    assert set(status) == set(jbatch.read_status(str(tmp_path / "jax" / "b_cellBycell")))


def test_batch_shards_match_jax(tmp_path, monkeypatch):
    names = [f"im{i}.tif" for i in range(5)]
    root = _root(tmp_path / "data", names)

    def seen(mod, **kw):
        got = []
        mod.run_batch(str(root), lambda img, out: got.append(os.path.basename(img)), **kw)
        shutil.rmtree(root)
        _root(root, names)
        return got

    for i in range(3):
        t = seen(tbatch, shard=(i, 3))
        assert t == seen(jbatch, shard=(i, 3)) == names[i::3]
    monkeypatch.setenv("HCUNET_SHARD_INDEX", "1")
    monkeypatch.setenv("HCUNET_SHARD_COUNT", "2")
    assert tbatch.host_shard() == jbatch.host_shard() == (1, 2)
    assert seen(tbatch) == seen(jbatch) == names[1::2]
    monkeypatch.delenv("HCUNET_SHARD_INDEX")
    monkeypatch.delenv("HCUNET_SHARD_COUNT")
    assert tbatch.host_shard() == (0, 1)


_WORKER = """
import json, os, sys
import torch.distributed as dist
rank, port, data_root, out_json = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
from hcunet_tpu_torch.apps.batch import host_shard, run_batch
shard = host_shard()
assert shard == (rank, 2), shard

def analyze_fn(img, out_dir):
    with open(os.path.join(out_dir, f"analyzed_by_{rank}.txt"), "w") as f:
        f.write(img)

results = run_batch(data_root, analyze_fn)
dist.barrier()
dist.destroy_process_group()
with open(out_json, "w") as f:
    json.dump({"shard": list(shard), "images": [os.path.basename(r["image"]) for r in results],
               "states": [r["state"] for r in results]}, f)
assert "jax" not in sys.modules and "hcunet_tpu" not in sys.modules
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_batch(tmp_path):
    """Two processes in one gloo group over one data root: each takes its
    shard from ``torch.distributed`` (rank, world size); the manifests are
    disjoint and cover every image, interleaved as ``images[rank::2]``."""
    names = [f"im{i}.tif" for i in range(5)]
    data_root = tmp_path / "study"
    data_root.mkdir()
    for n in names:
        (data_root / n).write_bytes(b"x")  # run_batch only globs paths
    port = str(_free_port())
    outs = [tmp_path / f"result_{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(i), port, str(data_root), str(outs[i])],
            cwd=REPO_ROOT,
        )
        for i in range(2)
    ]
    try:
        rcs = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0, 0]
    results = [json.loads(o.read_text()) for o in outs]
    by_shard = {tuple(r["shard"]): r["images"] for r in results}
    assert by_shard == {(0, 2): names[0::2], (1, 2): names[1::2]}
    assert all(s == "done" for r in results for s in r["states"])
    for i, n in enumerate(names):
        out_dir = data_root / f"{os.path.splitext(n)[0]}_cellBycell"
        assert (out_dir / f"analyzed_by_{i % 2}.txt").exists()
        assert not (out_dir / f"analyzed_by_{1 - i % 2}.txt").exists()
        assert json.loads((out_dir / "analysis_manifest.json").read_text())["state"] == "done"
