"""DAVIS evaluation protocol: gt loading, results loading, J&F scoring.

The port's copy of `slowfast_vos_tpu/eval/scorer.py`, an implementation of
the vendored official scorer the reference ships
(`code/davis2017_evaluation/davis2017/{davis,results,evaluation}.py`):

* gt masks read from `Annotations/<res>/<seq>/*.png`; 2017 palette ids are
  separate objects with id 255 = void; 2016 masks are binary (0/255);
* result masks read from `<res_path>/<seq>/<frame_id>.png`, `/255` for
  2016-style binary masks, split per object id otherwise;
* `semi-supervised` task: first and last frames are excluded from scoring;
* `unsupervised` task: up to 20 proposals, Hungarian-matched to gt objects by
  mean (J+F)/2 via `scipy.optimize.linear_sum_assignment`;
* per-object statistics are (mean, recall, decay) from `eval/metrics.py`.

The on-disk PNG contract is identical to the reference's, so masks produced
by either framework score interchangeably.
"""
from __future__ import annotations

import os
import warnings
from glob import glob

import numpy as np
from PIL import Image
from scipy.optimize import linear_sum_assignment

from slowfast_vos_tpu_torch.data.davis import imageset_sequences
from slowfast_vos_tpu_torch.eval.metrics import (
    boundary_f_measure,
    db_statistics,
    dilate_in_bbox,
    disk_kernel,
    jaccard,
    seg_to_boundary,
)


class DavisScorer:
    def __init__(
        self,
        davis_root: str,
        task: str = "unsupervised",
        gt_set: str = "val",
        sequences="all",
        year: str = "2016",
        resolution: str = "480p",
    ):
        if task not in ("unsupervised", "semi-supervised"):
            raise ValueError(f"unknown DAVIS task {task!r}")
        self.task = task
        self.year = year
        self.root = davis_root
        self.mask_path = os.path.join(davis_root, "Annotations", resolution)
        if sequences == "all":
            self.sequences = imageset_sequences(davis_root, gt_set, year, resolution)
        else:
            self.sequences = sequences if isinstance(sequences, list) else [sequences]

    # -- gt / results loading -------------------------------------------------

    def _gt_masks(self, seq: str):
        """Returns (gt [O,T,H,W] bool, void [T,H,W] bool | None, frame_ids)."""
        paths = sorted(glob(os.path.join(self.mask_path, seq, "*.png")))
        frame_ids = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        raw = np.stack([np.array(Image.open(p)) for p in paths])
        if self.year == "2016":
            if raw.max() == 255:
                raw = raw // 255
            gt = (raw > 0)[None]  # single object
            void = None
        else:
            void = raw == 255
            raw = np.where(void, 0, raw)
            # Protocol quirk kept: the object count comes from FRAME 0 only
            # (`davis.py:101` `num_objects = int(np.max(masks[0, ...]))`);
            # every DAVIS object is annotated in frame 0, and matching the
            # reference keeps the two scorers numerically interchangeable.
            num_objects = int(raw[0].max())
            ids = np.arange(1, num_objects + 1)
            gt = raw[None] == ids[:, None, None, None]
        return gt, void, frame_ids

    def _result_raw(self, res_path: str, seq: str, frame_ids):
        """Raw proposal-id raster [T, H, W] uint8 (0 = background) + the
        proposal count (= max id present in any frame, `results.py:31`).
        The streaming unsupervised scorer consumes this directly — the
        official [P, T, H, W] bool stack (566 MB at 20 proposals x val
        scale) is never materialized."""
        first = np.array(Image.open(os.path.join(res_path, seq, f"{frame_ids[0]}.png")))
        masks = np.zeros((len(frame_ids), *first.shape[:2]), np.uint8)
        for i, fid in enumerate(frame_ids):
            masks[i] = np.array(Image.open(os.path.join(res_path, seq, f"{fid}.png")))
        if self.year == "2016" and masks.max() == 255:
            masks //= 255
        num_objects = 1 if self.year == "2016" else int(masks.max())
        return masks, max(num_objects, 1)

    def _result_masks(self, res_path: str, seq: str, frame_ids, max_objects: int):
        masks, num_objects = self._result_raw(res_path, seq, frame_ids)
        ids = np.arange(1, num_objects + 1, dtype=np.uint8)
        return masks[None] == ids[:, None, None, None]

    # -- scoring --------------------------------------------------------------

    @staticmethod
    def _score_semisupervised(gt, res, void):
        n_obj = gt.shape[0]
        if res.shape[0] < n_obj:
            res = np.concatenate(
                [res, np.zeros((n_obj - res.shape[0], *res.shape[1:]), bool)]
            )
        j = np.stack([jaccard(gt[o], res[o], void) for o in range(n_obj)])
        f = np.stack([boundary_f_measure(gt[o], res[o], void) for o in range(n_obj)])
        return j, f

    @staticmethod
    def _score_unsupervised(gt, res_raw, n_prop, void, max_n_proposals=20):
        """gt: [O, T, H, W] bool (disjoint); res_raw: [T, H, W] uint8
        proposal-id raster (0 = background), n_prop = max id present.

        The official per-pair loop recomputes boundaries/dilations and
        full-frame boolean reductions for all O x P pairs over materialized
        [P, T, H, W] stacks (`davis2017/evaluation.py:46-66`,
        `results.py:23-35`). Here everything STREAMS per frame: J for ALL
        pairs from one bincount of the joint id raster (the decompositions
        are disjoint), boundaries+dilations once per present mask (absent
        proposals skip both), per-pair boundary overlaps on bit-packed
        bytes + popcounts. Integer counts — and therefore scores — are
        identical to the per-pair formulation (oracle-tested to 1e-12
        against the vendored reference scorer)."""
        if n_prop > max_n_proposals:
            raise ValueError(f"{n_prop} proposals in one sequence, more than the protocol's {max_n_proposals}")
        n_obj, t = gt.shape[0], gt.shape[1]
        # Ids beyond n_prop are never present == the official zero-mask pad
        # when there are fewer proposals than objects.
        n_eff = max(n_prop, n_obj)
        radius = np.ceil(0.008 * np.linalg.norm(gt.shape[-2:]))
        kernel = disk_kernel(int(radius))

        inter = np.zeros((n_eff + 1, n_obj + 1, t), np.int64)
        n_fg_b = np.zeros((n_eff, t), np.int64)
        n_gt_b = np.zeros((n_obj, t), np.int64)
        match_fg = np.zeros((n_eff, n_obj, t), np.int64)  # |fg_b & gt_dil|
        match_gt = np.zeros((n_eff, n_obj, t), np.int64)  # |gt_b & fg_dil|

        r = int(radius)

        def prep(mask_bool):
            """(packed boundary, packed dilation | None-if-empty); the
            dilation is bbox-confined (`dilate_in_bbox`)."""
            b = seg_to_boundary(mask_bool)
            if not b.any():
                return np.packbits(b, axis=-1), None
            dil = dilate_in_bbox(b, kernel, r)
            return np.packbits(b, axis=-1), np.packbits(dil, axis=-1)

        for i in range(t):
            nv = None if void is None else ~void[i].astype(bool)
            res_i = res_raw[i].astype(np.int32)
            gt_ids = np.zeros(res_i.shape, np.int32)
            for o in range(n_obj):
                gt_ids[gt[o, i]] = o + 1
            if nv is not None:
                gt_ids *= nv
                res_i *= nv
            code = gt_ids.ravel() * (n_eff + 1) + res_i.ravel()
            counts = np.bincount(code, minlength=(n_obj + 1) * (n_eff + 1)).reshape(
                n_obj + 1, n_eff + 1
            )
            inter[:, :, i] = counts.T

            gt_pre = []
            for o in range(n_obj):
                m = gt[o, i] if nv is None else gt[o, i] & nv
                gp, gdp = prep(m)
                gt_pre.append((gp, gdp))
                n_gt_b[o, i] = np.bitwise_count(gp).sum()
            for p in range(n_eff):
                if counts[:, p + 1].sum() == 0:  # absent proposal: all zero
                    continue
                fp, fdp = prep(res_i == p + 1)
                nf = int(np.bitwise_count(fp).sum())
                n_fg_b[p, i] = nf
                for o in range(n_obj):
                    gp, gdp = gt_pre[o]
                    if nf and gdp is not None:
                        match_fg[p, o, i] = np.bitwise_count(fp & gdp).sum()
                    if n_gt_b[o, i] and fdp is not None:
                        match_gt[p, o, i] = np.bitwise_count(gp & fdp).sum()

        n_gt_px = inter.sum(axis=0)[1:]  # [O, T]
        n_res_px = inter.sum(axis=1)[1:]  # [P, T]
        ip = inter[1:, 1:]
        union = n_res_px[:, None, :] + n_gt_px[None, :, :] - ip
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            j = np.where(union == 0, 1.0, ip / union)
            precision = match_fg / n_fg_b[:, None, :]
            recall = match_gt / n_gt_b[None, :, :]
            f = 2 * precision * recall / (precision + recall)
        f = np.where(np.isnan(f) | np.isinf(f), 0.0, f)
        both_empty = (n_fg_b[:, None, :] == 0) & (n_gt_b[None, :, :] == 0)
        one_empty = (n_fg_b[:, None, :] == 0) ^ (n_gt_b[None, :, :] == 0)
        f = np.where(both_empty, 1.0, f)
        f = np.where(one_empty, 0.0, f)

        combined = (j.mean(axis=2) + f.mean(axis=2)) / 2
        row, col = linear_sum_assignment(-combined)
        return j[row, col], f[row, col]

    def evaluate(self, res_path: str) -> dict:
        """Score a results directory. Returns the same nested structure as the
        reference scorer: {'J': {M, R, D, M_per_object}, 'F': {...}}."""
        out = {
            "J": {"M": [], "R": [], "D": [], "M_per_object": {}},
            "F": {"M": [], "R": [], "D": [], "M_per_object": {}},
        }
        for seq in self.sequences:
            gt, void, frame_ids = self._gt_masks(seq)
            if self.task == "semi-supervised":
                gt = gt[:, 1:-1]
                void = None if void is None else void[1:-1]
                frame_ids = frame_ids[1:-1]
            if self.task == "unsupervised":
                res_raw, n_prop = self._result_raw(res_path, seq, frame_ids)
                j, f = self._score_unsupervised(gt, res_raw, n_prop, void)
            else:
                res = self._result_masks(res_path, seq, frame_ids, gt.shape[0])
                # Protocol quirk kept: the reference scores semi-supervised
                # WITHOUT void exclusion (`evaluation.py:97` passes None even
                # when void masks exist) — matched for interchangeability.
                j, f = self._score_semisupervised(gt, res, None)
            for o in range(gt.shape[0]):
                name = f"{seq}_{o + 1}"
                jm, jr, jd = db_statistics(j[o])
                fm, fr, fd = db_statistics(f[o])
                out["J"]["M"].append(jm)
                out["J"]["R"].append(jr)
                out["J"]["D"].append(jd)
                out["J"]["M_per_object"][name] = jm
                out["F"]["M"].append(fm)
                out["F"]["R"].append(fr)
                out["F"]["D"].append(fd)
                out["F"]["M_per_object"][name] = fm
        return out


def summarize(metrics: dict):
    """Global summary row: (J&F-Mean, J-Mean, J-Recall, J-Decay, F-Mean,
    F-Recall, F-Decay), matching the reference's pandas table columns."""
    j, f = metrics["J"], metrics["F"]
    jf = (np.mean(j["M"]) + np.mean(f["M"])) / 2
    return {
        "J&F-Mean": float(jf),
        "J-Mean": float(np.mean(j["M"])),
        "J-Recall": float(np.mean(j["R"])),
        "J-Decay": float(np.mean(j["D"])),
        "F-Mean": float(np.mean(f["M"])),
        "F-Recall": float(np.mean(f["R"])),
        "F-Decay": float(np.mean(f["D"])),
    }
