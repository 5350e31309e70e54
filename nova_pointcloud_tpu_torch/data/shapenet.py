"""PointFlow-style ShapeNet / ModelNet point-cloud datasets (a copy of
``nova_pointcloud_tpu/data/shapenet.py``, host numpy: the port imports
nothing of the JAX package, and its output is bitwise the same for a seed).

- 15k-point .npy per mesh; deterministic shuffle with seed 38383, train =
  the first 10k points / test = the last 5k
- dataset-level or per-shape mean/std normalization
- the 55-synset ShapeNet name map
- GlobalNormalizer persisted to stats.json, read at evaluation
- "a {class}" prompts
- procedural stand-in clouds (spheres, boxes, cylinders) when no tree is
  on disk
"""

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# ShapeNet synset-id -> human name (55 categories, `dataset.py:9-31`)
SYNSET_TO_NAME = {
    "02691156": "airplane", "02773838": "bag", "02801938": "basket",
    "02808440": "bathtub", "02818832": "bed", "02828884": "bench",
    "02876657": "bottle", "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02747177": "can", "02942699": "camera",
    "02954340": "cap", "02958343": "car", "03001627": "chair",
    "03046257": "clock", "03207941": "dishwasher", "03211117": "monitor",
    "04379243": "table", "04401088": "telephone", "02946921": "tin_can",
    "04460130": "tower", "04468005": "train", "03085013": "keyboard",
    "03261776": "earphone", "03325088": "faucet", "03337140": "file",
    "03467517": "guitar", "03513137": "helmet", "03593526": "jar",
    "03624134": "knife", "03636649": "lamp", "03642806": "laptop",
    "03691459": "speaker", "03710193": "mailbox", "03759954": "microphone",
    "03761084": "microwave", "03790512": "motorcycle", "03797390": "mug",
    "03928116": "piano", "03938244": "pillow", "03948459": "pistol",
    "03991062": "pot", "04004475": "printer", "04074963": "remote_control",
    "04090263": "rifle", "04099429": "rocket", "04225987": "skateboard",
    "04256520": "sofa", "04330267": "stove", "04530566": "vessel",
    "04554684": "washer", "02992529": "cellphone", "02843684": "birdhouse",
    "04285008": "sports_car",
}
NAME_TO_SYNSET = {v: k for k, v in SYNSET_TO_NAME.items()}

SHUFFLE_SEED = 38383  # deterministic per-shape point shuffle (`dataset.py:83`)


class GlobalNormalizer:
    """Dataset-level mean/std with stats.json persistence.

    Parity with `train_newloss.py:248-300` (fit over a sample of shapes,
    normalize to zero-mean/unit-std, clip outliers) and the stats.json format
    read by `test_optimize.py:39-61`.
    """

    def __init__(self, mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None, clip: float = 5.0):
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)
        self.clip = clip

    @property
    def fitted(self) -> bool:
        return self.mean is not None

    def fit(self, clouds: Sequence[np.ndarray]) -> "GlobalNormalizer":
        allpts = np.concatenate([np.asarray(c, np.float32).reshape(-1, 3)
                                 for c in clouds], axis=0)
        self.mean = allpts.mean(axis=0)
        self.std = allpts.std(axis=0) + 1e-8
        return self

    def normalize(self, points):
        out = (points - self.mean) / self.std
        return np.clip(out, -self.clip, self.clip) if isinstance(out, np.ndarray) else out

    def denormalize(self, points):
        return points * self.std + self.mean

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"mean": self.mean.tolist(), "std": self.std.tolist(),
                       "clip": self.clip}, f)

    @classmethod
    def load(cls, path: str) -> "GlobalNormalizer":
        with open(path) as f:
            d = json.load(f)
        return cls(np.asarray(d["mean"]), np.asarray(d["std"]),
                   d.get("clip", 5.0))


class Uniform15KPC:
    """Base dataset: one 15k-point .npy per mesh under root/synset/split/.

    Parity with `dataset.py:33-165`: deterministic shuffle, train/test point
    split, dataset-level or per-shape normalization.
    """

    def __init__(self, root: str, subdirs: Sequence[str], split: str = "train",
                 tr_sample_size: int = 10000, te_sample_size: int = 5000,
                 normalize_per_shape: bool = False,
                 normalizer: Optional[GlobalNormalizer] = None,
                 max_shapes: Optional[int] = None):
        self.root, self.split = root, split
        self.tr_sample_size, self.te_sample_size = tr_sample_size, te_sample_size
        self.normalize_per_shape = normalize_per_shape
        self.normalizer = normalizer
        self.files: List[Tuple[str, str]] = []  # (synset, path)
        for sub in subdirs:
            d = os.path.join(root, sub, split)
            if not os.path.isdir(d):
                continue
            for fname in sorted(os.listdir(d)):
                if fname.endswith(".npy"):
                    self.files.append((sub, os.path.join(d, fname)))
        if max_shapes:
            self.files = self.files[:max_shapes]
        self._rng = np.random.RandomState(SHUFFLE_SEED)
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, idx: int) -> np.ndarray:
        if idx not in self._cache:
            pts = np.load(self.files[idx][1]).astype(np.float32)
            perm = np.random.RandomState(SHUFFLE_SEED).permutation(len(pts))
            self._cache[idx] = pts[perm]
            if len(self._cache) > 512:  # bounded cache (`train_newloss.py:64`)
                self._cache.pop(next(iter(self._cache)))
        return self._cache[idx]

    def prompt(self, idx: int) -> str:
        synset = self.files[idx][0]
        return f"a {SYNSET_TO_NAME.get(synset, synset)}"

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        pts = self._load(idx)
        if self.split == "train":
            pool = pts[: self.tr_sample_size]
            n = min(self.tr_sample_size, len(pool))
        else:
            pool = pts[self.tr_sample_size: self.tr_sample_size
                       + self.te_sample_size]
            if len(pool) == 0:
                # file has fewer than tr_sample_size points (the reference
                # assumes exactly 15k, `dataset.py:110-111`); fall back to
                # the cloud's tail rather than an empty eval pool
                pool = pts[-min(len(pts), self.te_sample_size):]
            n = min(self.te_sample_size, len(pool))
        sel = np.random.randint(0, len(pool), n) if self.split == "train" \
            else np.arange(n)
        out = pool[sel]
        if self.normalize_per_shape:
            m, s = out.mean(0), out.std(0).mean() + 1e-8
            out = (out - m) / s
        elif self.normalizer is not None and self.normalizer.fitted:
            out = self.normalizer.normalize(out)
        return {"points": out.astype(np.float32), "prompt": self.prompt(idx),
                "synset": self.files[idx][0]}


class ShapeNet15kPointClouds(Uniform15KPC):
    """All (or chosen) ShapeNet categories (`dataset.py:240-359`)."""

    def __init__(self, root: str, categories: Sequence[str] = ("all",), **kw):
        if "all" in categories:
            subs = list(SYNSET_TO_NAME)
        else:
            subs = [NAME_TO_SYNSET.get(c, c) for c in categories]
        super().__init__(root, subs, **kw)


class ModelNet40PointClouds(Uniform15KPC):
    """ModelNet40 (`dataset.py:167-202`); subdirs are class names."""

    def __init__(self, root: str, **kw):
        subs = sorted(os.listdir(root)) if os.path.isdir(root) else []
        super().__init__(root, subs, **kw)


class ModelNet10PointClouds(ModelNet40PointClouds):
    """ModelNet10 (`dataset.py:204-238`)."""


def make_batches(dataset, batch_size: int, num_points: int,
                 seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Simple host-side batcher: resamples each cloud to ``num_points``,
    forever (reshuffled each epoch when ``shuffle``)."""
    rng = np.random.RandomState(seed)
    order = np.arange(len(dataset))
    while True:
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            idxs = order[i: i + batch_size]
            pts, prompts = [], []
            for j in idxs:
                item = dataset[int(j)]
                p = item["points"]
                sel = rng.randint(0, len(p), num_points) if len(p) != num_points \
                    else np.arange(num_points)
                pts.append(p[sel])
                prompts.append(item["prompt"])
            yield {"points": np.stack(pts), "prompts": prompts}


def make_synthetic_clouds(num_shapes: int, num_points: int = 2048,
                          seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Procedural stand-in data (spheres/boxes/cylinders) for tests/benches
    when no ShapeNet tree is on disk — the reference's Dummy* bootstrap
    pattern applied to data."""
    rng = np.random.RandomState(seed)
    shapes = []
    kinds = ["sphere", "box", "cylinder"]
    for i in range(num_shapes):
        kind = kinds[i % len(kinds)]
        if kind == "sphere":
            v = rng.randn(num_points, 3).astype(np.float32)
            pts = v / np.linalg.norm(v, axis=1, keepdims=True)
        elif kind == "box":
            pts = rng.uniform(-1, 1, (num_points, 3)).astype(np.float32)
            axis = rng.randint(0, 3, num_points)
            sign = rng.choice([-1.0, 1.0], num_points)
            pts[np.arange(num_points), axis] = sign
        else:
            theta = rng.uniform(0, 2 * np.pi, num_points)
            z = rng.uniform(-1, 1, num_points)
            pts = np.stack([np.cos(theta), np.sin(theta), z], 1).astype(np.float32)
        shapes.append({"points": pts * 0.8, "prompt": f"a {kind}",
                       "synset": kind})
    return shapes
