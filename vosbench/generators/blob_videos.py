"""Moving-blob videos: the DAVIS-shaped traffic of every cell.

The scene of the port's `data/synthetic.py::draw_sequence`: a textured
background (uniform 0-80 per channel) and `k` elliptic blobs (radii 8-20%
of the short side, 1.3:1, colours 120-255) moving at up to 3 px a frame
from the middle half of the frame; a later blob covers an earlier one, and
object o has id o + 1. The frames are drawn on the device in bulk, a
sequence at a time, from a numpy generator keyed by (seed, sequence).

Every seed gets the same sequence lengths, as listed, and the same multiset
of object counts, in an order drawn from the seed, so the work a seed gives
is fixed and only its content changes; inference draws the order it runs
them in from the seed (`passes`).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

# DAVIS palette of the first 16 ids, as the annotation PNGs carry it.
PALETTE = np.zeros((256, 3), np.uint8)
PALETTE[:16] = [[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128], [128, 0, 128], [0, 128, 128],
                [128, 128, 128], [64, 0, 0], [191, 0, 0], [64, 128, 0], [191, 128, 0], [64, 0, 128], [191, 0, 128],
                [64, 128, 128], [191, 128, 128]]


def video(rng: np.random.Generator, t: int, hw, objects: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(frames [t, H, W, 3] uint8, ids [t, H, W] uint8) on `device`."""
    h, w = hw
    g = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    bg = (torch.rand((h, w, 3), generator=g, device=device) * 80).to(torch.uint8)
    centers = rng.uniform([0.25 * w, 0.25 * h], [0.75 * w, 0.75 * h], (objects, 2))
    vels = rng.uniform(-3, 3, (objects, 2))
    radii = rng.uniform(min(h, w) * 0.08, min(h, w) * 0.2, objects)
    colors = torch.as_tensor(rng.integers(120, 255, (objects, 3)), dtype=torch.uint8, device=device)
    f = torch.arange(t, dtype=torch.float32, device=device)[:, None, None]
    yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    ids = torch.zeros((t, h, w), dtype=torch.uint8, device=device)
    for o in range(objects):
        cx, cy = centers[o, 0] + vels[o, 0] * f, centers[o, 1] + vels[o, 1] * f
        r = float(radii[o])
        blob = (xx - cx) ** 2 / (1.3 * r) ** 2 + (yy - cy) ** 2 / r**2 <= 1.0
        ids = torch.where(blob, o + 1, ids)
    palette = torch.cat([bg.new_zeros((1, 3)), colors])
    frames = torch.where((ids > 0)[..., None], palette[ids.long()], bg)
    return frames, ids


def plan(traffic: dict, seed: int) -> list[tuple[int, int]]:
    """The (length, objects) of each distinct sequence: the lengths as
    listed, the object counts in the seed's order."""
    objects = list(traffic["objects"])
    order = np.random.default_rng([seed, 0]).permutation(len(objects))
    return [(t, objects[j]) for t, j in zip(traffic["lengths"], order)]


def sequences(traffic: dict, seed: int, hw, device) -> list[np.ndarray]:
    """The distinct sequences' frames, uint8 [T, H, W, 3] on the host."""
    out = []
    for i, (t, k) in enumerate(plan(traffic, seed)):
        frames, _ = video(np.random.default_rng([seed, 1, i]), t, hw, k, device)
        out.append(frames.cpu().numpy())
    return out


def passes(traffic: dict, seed: int, count: int) -> list[int]:
    """Indices into `sequences`: `count` passes, each over every sequence in
    an order drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    n = len(traffic["lengths"])
    return [int(i) for _ in range(count) for i in rng.permutation(n)]


def write_tree(traffic: dict, seed: int, hw, root: str, device, threads: int = 4) -> list[str]:
    """A DAVIS-2017-layout tree under `root`: `JPEGImages/480p/<name>/*.jpg`
    (quality `jpeg_quality`), palette PNG `Annotations`, and
    `ImageSets/2017/train.txt` listing the sequences in `plan`'s order."""
    names = []
    jobs = []
    for i, (t, k) in enumerate(plan(traffic, seed)):
        name = f"blobs{i:02d}"
        names.append(name)
        frames, ids = video(np.random.default_rng([seed, 1, i]), t, hw, k, device)
        frames, ids = frames.cpu().numpy(), ids.cpu().numpy()
        for sub in ("JPEGImages", "Annotations"):
            os.makedirs(os.path.join(root, sub, "480p", name), exist_ok=True)
        for f in range(t):
            jobs.append((frames[f], ids[f], os.path.join(root, "JPEGImages", "480p", name, f"{f:05d}.jpg"),
                         os.path.join(root, "Annotations", "480p", name, f"{f:05d}.png")))

    def save(job):
        frame, ids, jpg, png = job
        Image.fromarray(frame).save(jpg, quality=traffic["jpeg_quality"])
        mask = Image.fromarray(ids, mode="P")
        mask.putpalette(PALETTE.ravel().tolist())
        mask.save(png)

    with ThreadPoolExecutor(threads) as pool:
        for r in pool.map(save, jobs):
            del r
    os.makedirs(os.path.join(root, "ImageSets", "2017"), exist_ok=True)
    with open(os.path.join(root, "ImageSets", "2017", "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names
