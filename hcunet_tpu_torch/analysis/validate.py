"""Validation utilities (twin of ``hcunet_tpu/analysis/validate.py``).

Two layers, mirroring the reference's validation scripts:

* **Segmentation QA** (``valscripts/generate_histograms.py:44-86``): dice
  and missed/false pixel ratios of predictions vs manual masks, plus
  manual-vs-auto GFP intensity histograms.
* **Study aggregation** (``validate.py:77-177,386-415``): parse experiment
  metadata (promoter / animal / gain / laser / day) from directory names,
  aggregate per-cell channel statistics across images, and regress GFP
  intensity against acquisition gain (numpy least squares in place of the
  reference's sklearn).  ``StudyAggregate.dataframe`` needs pandas and
  ``save_figures`` matplotlib, imported when called.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hcunet_tpu_torch.core.precision import exact_float32

# ---------------------------------------------------------------------------
# segmentation QA
# ---------------------------------------------------------------------------


def dice_score(pred: np.ndarray, truth: np.ndarray, eps: float = 1e-10) -> float:
    p = np.asarray(pred) > 0
    t = np.asarray(truth) > 0
    return float((2 * (p & t).sum() + eps) / (p.sum() + t.sum() + eps))


def pixel_error_rates(pred: np.ndarray, truth: np.ndarray) -> Tuple[float, float]:
    """(missed_ratio, false_ratio): fraction of true pixels missed, and
    fraction of predicted pixels that are false positives."""
    p = np.asarray(pred) > 0
    t = np.asarray(truth) > 0
    missed = float((t & ~p).sum() / max(t.sum(), 1))
    false = float((p & ~t).sum() / max(p.sum(), 1))
    return missed, false


def gfp_histograms(
    image: np.ndarray,
    pred_mask: np.ndarray,
    true_mask: np.ndarray,
    channel: int = 1,
    bins: int = 50,
):
    """Manual-vs-auto intensity histograms over the masked GFP channel."""
    ch = image[..., channel]
    rng = (float(ch.min()), float(ch.max()) or 1.0)
    auto, edges = np.histogram(ch[np.asarray(pred_mask) > 0], bins=bins, range=rng)
    manual, _ = np.histogram(ch[np.asarray(true_mask) > 0], bins=bins, range=rng)
    return {"auto": auto, "manual": manual, "edges": edges}


@exact_float32()
def validate_segmentation(
    unet_apply,
    dataset,
    unet_cfg,
    tile_cfg=None,
    threshold: float = 0.5,
    device=None,
) -> List[Dict]:
    """Run the model over a Stack-style dataset and score each sample.

    ``unet_apply`` maps a tile batch on ``device`` (CUDA unless given) to
    logits (:func:`hcunet_tpu_torch.infer.compile.compile_serving_apply`);
    the probability map comes from
    :func:`hcunet_tpu_torch.infer.tiling.predict_segmentation_mask`."""
    from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask

    results = []
    for i in range(len(dataset)):
        image, mask, _pwl = dataset[i]
        prob = predict_segmentation_mask(
            unet_apply, np.asarray(image, np.float32), unet_cfg, tile_cfg,
            use_probability_map=True, device=device,
        )
        prob = prob.cpu().numpy()[0, ..., 0]
        pred = prob > threshold
        truth = np.asarray(mask)[0, ..., 0]
        missed, false = pixel_error_rates(pred, truth)
        results.append(
            {
                "index": i,
                "dice": dice_score(pred, truth),
                "missed_ratio": missed,
                "false_ratio": false,
                "hist": gfp_histograms(np.asarray(image)[0], pred, truth),
            }
        )
    return results


# ---------------------------------------------------------------------------
# legacy result loading (``validate.py:16-31``)
# ---------------------------------------------------------------------------


def load_legacy_cells(path: str) -> List:
    """Load a reference-era ``all_cells.pkl``.

    The reference pickles ``HairCell`` objects under two historical module
    paths (``haircell`` and ``hcat.haircell``, see the RenameUnpickler shim
    at ``validate.py:16-31``); neither exists here, so both resolve to a
    plain attribute-carrying shim class.  Torch-tensor statistics inside
    ``signal_stats``/``gfp_stats`` are converted to floats.  Returned
    objects expose the attribute surface ``StudyAggregate.add_image`` needs
    (``unique_id``, ``volume``, ``is_bad``, ``signal_stats``,
    ``distance_from_apex``).

    Security: ``find_class`` is restricted to an allowlist (the HairCell
    shim, numpy/torch tensor reconstructors, and a few builtins) — anything
    else raises ``pickle.UnpicklingError``.  Legacy pickles should still be
    treated as trusted inputs; the allowlist narrows, not removes, the risk.
    """
    import io
    import pickle

    class _LegacyHairCell:
        distance_from_apex: list = []

    # Reconstructors legacy HairCell pickles actually need: numpy arrays
    # (cell centers/coords), torch tensors inside signal_stats, and basic
    # container builtins.  Nothing here can be leveraged for code execution
    # (no os/subprocess/builtins.eval/functools.partial/...); the one entry
    # with a nested unpickler (torch.storage._load_from_bytes) is replaced
    # by a weights-only wrapper below.
    _ALLOWED = {
        ("builtins", "list"), ("builtins", "dict"), ("builtins", "set"),
        ("builtins", "tuple"), ("builtins", "frozenset"),
        ("builtins", "bytearray"), ("builtins", "complex"),
        ("collections", "OrderedDict"),
        ("numpy", "ndarray"), ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("torch._utils", "_rebuild_tensor_v2"),
        ("torch._utils", "_rebuild_tensor"),
        ("torch.serialization", "_get_layout"),
    }

    def _safe_load_from_bytes(b):
        # torch.storage._load_from_bytes itself calls torch.load on the
        # embedded bytes, which would spin up an UNRESTRICTED unpickler on
        # attacker-controlled data (a nested-gadget bypass of this very
        # allowlist).  Force the restricted weights-only loader instead —
        # tensor payloads (all a legacy HairCell carries) still load.
        import io as _io

        import torch

        return torch.load(_io.BytesIO(bytes(b)), weights_only=True)
    _NUMPY_SCALARS = {
        "bool_", "int8", "int16", "int32", "int64", "uint8", "uint16",
        "uint32", "uint64", "float16", "float32", "float64", "longdouble",
        "complex64", "complex128", "intp", "uintp",
    }

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if name == "HairCell" and module in (
                "haircell", "hcat.haircell", "hcunet_tpu.analysis.haircell",
                "hcunet_tpu_torch.analysis.haircell",
            ):
                return _LegacyHairCell
            if (module, name) == ("torch.storage", "_load_from_bytes"):
                return _safe_load_from_bytes
            if (module, name) in _ALLOWED:
                return super().find_class(module, name)
            if module == "numpy" and name in _NUMPY_SCALARS:
                return super().find_class(module, name)
            if module == "torch" and name.endswith("Storage"):
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"load_legacy_cells: refusing to unpickle {module}.{name} "
                "(not in the legacy HairCell allowlist)"
            )

    def _scalar(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return v

    with open(path, "rb") as f:
        cells = _Unpickler(io.BufferedReader(f)).load()
    for c in cells:
        for attr in ("signal_stats", "gfp_stats"):
            stats = getattr(c, attr, None)
            if isinstance(stats, dict):
                for k, v in stats.items():
                    if isinstance(v, dict):
                        stats[k] = {kk: _scalar(vv) for kk, vv in v.items()}
                    else:
                        stats[k] = _scalar(v)
    return cells


# ---------------------------------------------------------------------------
# study-level aggregation
# ---------------------------------------------------------------------------

# e.g. "Jul 18 AAV2-PHP.B-CMV m2 G80 L5 ..." — tolerant patterns like
# validate.py:77-110
_PATTERNS = {
    "promoter": re.compile(r"(CMV|Synapsin|SYN|CAG|smCBA)", re.I),
    "animal": re.compile(r"\bm(\d+)\b", re.I),
    "gain": re.compile(r"\bG(\d+)\b", re.I),
    "laser": re.compile(r"\bL(\d+(?:\.\d+)?)\b", re.I),
    "day": re.compile(r"\b(Jan|Feb|Mar|Apr|May|Jun|Jul|Aug|Sep|Oct|Nov|Dec)\s*(\d+)\b", re.I),
    "virus": re.compile(r"(AAV[\w.\-]*)", re.I),
}


def parse_experiment_metadata(path: str) -> Dict[str, Optional[str]]:
    name = os.path.basename(os.path.normpath(path))
    out: Dict[str, Optional[str]] = {}
    for key, pat in _PATTERNS.items():
        m = pat.search(name)
        if not m:
            out[key] = None
        elif key == "day":
            out[key] = f"{m.group(1)} {m.group(2)}"
        else:
            out[key] = m.group(1)
    return out


@dataclass
class StudyAggregate:
    rows: List[Dict] = field(default_factory=list)

    def add_image(self, path: str, cells: Sequence) -> None:
        meta = parse_experiment_metadata(path)
        for c in cells:
            if getattr(c, "is_bad", False):
                continue
            row = dict(meta)
            row.update(
                image=path,
                unique_id=c.unique_id,
                volume=c.volume,
                percent_location=c.distance_from_apex,
            )
            for ch, stats in c.signal_stats.items():
                row[f"{ch}_mean"] = stats.get("mean")
                row[f"{ch}_std"] = stats.get("std")
                row[f"{ch}_median"] = stats.get("median")
            self.rows.append(row)

    def dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.rows)

    def gfp_vs_gain_regression(self) -> Optional[Dict[str, float]]:
        """Least-squares fit of mean GFP against acquisition gain
        (``validate.py:386-415``)."""
        xs, ys = [], []
        for r in self.rows:
            if r.get("gain") is None or r.get("gfp_mean") is None:
                continue
            if not np.isfinite(r["gfp_mean"]):
                continue
            xs.append(float(r["gain"]))
            ys.append(float(r["gfp_mean"]))
        if len(xs) < 2:
            return None
        slope, intercept = np.polyfit(xs, ys, 1)
        pred = slope * np.asarray(xs) + intercept
        ss_res = float(((np.asarray(ys) - pred) ** 2).sum())
        ss_tot = float(((np.asarray(ys) - np.mean(ys)) ** 2).sum()) or 1e-12
        return {
            "slope": float(slope),
            "intercept": float(intercept),
            "r2": 1.0 - ss_res / ss_tot,
            "n": len(xs),
        }

    def save_figures(
        self,
        out_dir: str,
        channels: Sequence[str] = ("dapi", "gfp", "myo7a", "actin"),
        group_by: str = "promoter",
    ) -> List[str]:
        """The study plots of ``validate.py:386-415``: per-channel intensity
        boxplots grouped by experiment metadata, and the GFP-vs-gain
        scatter with the fitted regression line.  Returns saved paths."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(out_dir, exist_ok=True)
        saved: List[str] = []

        groups: Dict[str, List[Dict]] = {}
        for r in self.rows:
            groups.setdefault(str(r.get(group_by)), []).append(r)

        fig, axes = plt.subplots(
            1, len(channels), figsize=(3.2 * len(channels), 4), squeeze=False
        )
        for ax, ch in zip(axes[0], channels):
            data, labels = [], []
            for g, rows in sorted(groups.items()):
                vals = [
                    r[f"{ch}_mean"] for r in rows
                    if r.get(f"{ch}_mean") is not None
                    and np.isfinite(r[f"{ch}_mean"])
                ]
                if vals:
                    data.append(vals)
                    labels.append(g)
            if data:
                ax.boxplot(data, tick_labels=labels)
            ax.set_title(ch)
            ax.tick_params(axis="x", rotation=45)
        fig.suptitle(f"per-cell mean intensity by {group_by}")
        fig.tight_layout()
        p = os.path.join(out_dir, "channel_boxplots.png")
        fig.savefig(p, dpi=120)
        plt.close(fig)
        saved.append(p)

        reg = self.gfp_vs_gain_regression()
        if reg is not None:
            xs = [
                float(r["gain"]) for r in self.rows
                if r.get("gain") is not None and r.get("gfp_mean") is not None
                and np.isfinite(r["gfp_mean"])
            ]
            ys = [
                float(r["gfp_mean"]) for r in self.rows
                if r.get("gain") is not None and r.get("gfp_mean") is not None
                and np.isfinite(r["gfp_mean"])
            ]
            fig, ax = plt.subplots(figsize=(5, 4))
            ax.plot(xs, ys, ".", alpha=0.5)
            gx = np.linspace(min(xs), max(xs), 10)
            ax.plot(gx, reg["slope"] * gx + reg["intercept"], "r-",
                    label=f"r²={reg['r2']:.2f} n={reg['n']}")
            ax.set_xlabel("gain")
            ax.set_ylabel("mean GFP")
            ax.legend()
            fig.tight_layout()
            p = os.path.join(out_dir, "gfp_vs_gain.png")
            fig.savefig(p, dpi=120)
            plt.close(fig)
            saved.append(p)
        return saved
