"""COCO caption data in the port: image preprocessing, the caption and
detector-feature datasets, fixed-shape batching.

A copy of ``image_captioning_ml_project_tpu.data.coco``, held equal to it
by the tests (same examples, same batches in the same order from the same
seed): training yields one example per (image, caption) annotation with
RandomResizedCrop + horizontal flip on the host, evaluation groups every
caption of an image, padded to a fixed reference count, with a resize +
center crop. Images leave the host as uint8 NHWC and are normalised on
their device (:func:`normalize_images`). With ``device_resize`` (eval
only) the host just decodes each image's centre square onto a fixed
canvas of about 1.5 x the image size (:func:`load_image_square`) and the
batch carries each square's side under ``image_size``; the card resizes
and normalises (:func:`..ops.resize.resize_normalize`).
:class:`ObjectDetectionFeaturesDataset` reads pre-extracted detector
regions (``.npz`` per image) instead of images.

Images are read with PIL, imported where an image is opened, or, with
``native_loader``, by the port's C++ JPEG pipeline (:mod:`..native`: one
call decodes a whole batch on host threads), which falls back to PIL when
it did not build and for each image it cannot decode.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NHWC, ``(x / 255 - mean) / std`` on the
    images' device."""
    x = images_uint8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# Host-side image transforms (PIL)
# ---------------------------------------------------------------------------


def draw_crop_box(W: int, H: int, rng: np.random.RandomState,
                  scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """The RandomResizedCrop box draw — torchvision semantics; returns
    (x, y, w, h) or None for the center-crop fallback."""
    area = W * H
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            x = rng.randint(0, W - w + 1)
            y = rng.randint(0, H - h + 1)
            return x, y, w, h
    return None


def random_resized_crop(img, size: int, rng: np.random.RandomState,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop semantics."""
    from PIL import Image

    W, H = img.size
    box = draw_crop_box(W, H, rng, scale, ratio)
    if box is not None:
        x, y, w, h = box
        return img.crop((x, y, x + w, y + h)).resize((size, size),
                                                     Image.BILINEAR)
    return center_crop_resize(img, size)


def center_crop_resize(img, size: int):
    """Resize a PIL image's shorter side to ``size`` (bilinear), then crop
    the ``size`` x ``size`` center (reference: src/main.py:147-150)."""
    from PIL import Image

    W, H = img.size
    scale = size / min(W, H)
    img = img.resize((max(size, int(round(W * scale))),
                      max(size, int(round(H * scale)))), Image.BILINEAR)
    W, H = img.size
    left = (W - size) // 2
    top = (H - size) // 2
    return img.crop((left, top, left + size, top + size))


def load_image(path: str, size: int, train: bool,
               rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Decode + transform one image to uint8 [size, size, 3]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if train:
        rng = rng or np.random
        img = random_resized_crop(img, size, rng)
        if rng.rand() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
    else:
        img = center_crop_resize(img, size)
    return np.asarray(img, dtype=np.uint8)


def load_image_square(path: str, target: int, canvas: int):
    """The decode-only host path of the device-resident resize: libjpeg
    decodes at a reduced DCT scale (PIL's ``draft``: the shorter side stays
    >= ``target`` where the original's is), the centred square (all that
    the eval transform's resize + centre crop keeps) is cut out and placed
    top-left on a ``[canvas, canvas, 3]`` uint8 canvas. A square larger
    than the canvas (not a JPEG, or a very large one) is downscaled to it
    on the host first. Returns (canvas image, side)."""
    from PIL import Image

    img = Image.open(path)
    img.draft("RGB", (target, target))
    arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
    h, w = arr.shape[:2]
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    sq = arr[top:top + side, left:left + side]
    if side > canvas:
        sq = np.asarray(Image.fromarray(sq).resize((canvas, canvas),
                                                   Image.BILINEAR),
                        dtype=np.uint8)
        side = canvas
    out = np.zeros((canvas, canvas, 3), dtype=np.uint8)
    out[:side, :side] = sq
    return out, np.int32(side)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


def build_caption_examples(annotations, image_id_to_filename,
                           is_training: bool):
    """Annotation rows -> example dicts, shared by the image and
    object-region datasets (reference: src/data/dataset.py:54-100):
    training yields one row per caption; eval groups all captions of an
    image into one row (``captions`` list, annotation order)."""
    examples = []
    for ann in annotations:
        if ann["image_id"] not in image_id_to_filename:
            continue
        examples.append({
            "image_id": ann["image_id"],
            "filename": image_id_to_filename[ann["image_id"]],
            "caption": ann["caption"],
        })
    if is_training:
        return examples
    grouped: Dict[int, Dict[str, Any]] = {}
    for ex in examples:
        g = grouped.setdefault(
            ex["image_id"], {"filename": ex["filename"], "captions": []})
        g["captions"].append(ex["caption"])
    return [
        {"image_id": iid, "filename": d["filename"],
         "captions": d["captions"]}
        for iid, d in grouped.items()
    ]


class COCOCaptionDataset:
    """COCO captions dataset (reference: src/data/dataset.py:12-177)."""

    def __init__(
        self,
        root_dir: str,
        annotation_file: str,
        image_dir: str,
        tokenizer,
        image_size: int = 224,
        max_length: int = 50,
        is_training: bool = True,
        max_ref_captions: int = 5,
        seed: int = 0,
        device_resize: bool = False,
        native_loader: bool = False,
        native_threads: int = 0,
        native_draft: bool = False,
    ):
        self.root_dir = root_dir
        self.image_dir = os.path.join(root_dir, image_dir)
        self.annotation_path = os.path.join(root_dir, annotation_file)
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.max_length = max_length
        self.is_training = is_training
        self.max_ref_captions = max_ref_captions
        self.rng = np.random.RandomState(seed)
        # the device-resident preprocessing, eval only (training's crops
        # need full-resolution pixels): a canvas of 1.5 x the image size,
        # a multiple of 16, holds the draft decode's centre square of any
        # original up to 3 x the image size
        self.device_resize = device_resize and not is_training
        self.canvas_size = -(-3 * image_size // 2 // 16) * 16
        # the native C++ decode (native/jpeg_loader.cpp): resolved at the
        # first image load, so building a dataset never compiles; PIL is
        # the fallback
        self.native_loader = native_loader
        self.native_threads = native_threads
        self.native_draft = native_draft
        self._native = None  # unresolved
        with open(self.annotation_path) as f:
            self.annotations = json.load(f)
        self._process_annotations()

    def _process_annotations(self):
        """reference: src/data/dataset.py:54-100."""
        self.image_id_to_filename = {
            img["id"]: img["file_name"] for img in self.annotations["images"]
        }
        self.examples = build_caption_examples(
            self.annotations["annotations"], self.image_id_to_filename,
            self.is_training)

    def __len__(self):
        return len(self.examples)

    def _native_mod(self):
        """The native loader module, or None (resolved once; PIL is the
        fallback)."""
        if self._native is None:
            self._native = False
            if self.native_loader:
                try:
                    from .. import native as _nmod
                    if _nmod.available():
                        self._native = _nmod
                except Exception:
                    pass
        return self._native or None

    def _path(self, idx: int) -> str:
        return os.path.join(self.image_dir, self.examples[idx]["filename"])

    def _load_native_one(self, path: str):
        """Native decode of one image (with ``device_resize``, its
        (canvas, side)), or None for the PIL fallback (the library
        missing, or an input it rejects)."""
        nl = self._native_mod()
        if nl is None:
            return None
        with open(path, "rb") as f:
            buf = f.read()
        if self.device_resize:
            canv, sides = nl.decode_square_batch(
                [buf], self.image_size, self.canvas_size, n_threads=1)
            return None if sides[0] < 0 else (canv[0], np.int32(sides[0]))
        if self.is_training:
            wh = nl.probe(buf)
            if wh is None:
                return None
            # snapshot the RNG: if the native decode fails after the box
            # and flip draws, the PIL fallback must see the same sequence
            rng_state = self.rng.get_state()
            box = draw_crop_box(wh[0], wh[1], self.rng)
            flip = bool(self.rng.rand() < 0.5)
            if box is None:  # center-crop fallback draw, then flip
                img, st = nl.decode_eval_batch([buf], self.image_size,
                                               draft=False, n_threads=1)
            else:
                img, st = nl.decode_train_batch(
                    [buf], np.array([box]), np.array([int(flip)]),
                    self.image_size, n_threads=1)
            if st[0] != 0:
                self.rng.set_state(rng_state)
                return None
            image = img[0]
            if box is None and flip:
                image = np.ascontiguousarray(image[:, ::-1])
            return image
        img, st = nl.decode_eval_batch([buf], self.image_size,
                                       draft=self.native_draft, n_threads=1)
        return img[0] if st[0] == 0 else None

    def decode_chunk(self, tasks) -> Optional[List[np.ndarray]]:
        """Decode the images of ``tasks = [(idx, sample_seed), ...]`` in
        one call to the native thread pool (the GIL released for the
        batch), with the same per-sample seeding as the PIL path. Returns
        the images aligned with ``tasks`` (with ``device_resize``, their
        (canvas, side) pairs), or None when the native library is
        unavailable; an image the native decoder rejects is decoded by PIL
        instead."""
        nl = self._native_mod()
        if nl is None:
            return None
        bufs = []
        for idx, _ in tasks:
            with open(self._path(idx), "rb") as f:
                bufs.append(f.read())
        nt = self.native_threads or None
        if self.device_resize:
            canv, sides = nl.decode_square_batch(
                bufs, self.image_size, self.canvas_size, n_threads=nt)
            return [(canv[j], np.int32(sides[j])) if sides[j] >= 0 else
                    load_image_square(self._path(idx), self.image_size,
                                      self.canvas_size)
                    for j, (idx, _) in enumerate(tasks)]
        if not self.is_training:
            imgs, st = nl.decode_eval_batch(bufs, self.image_size,
                                            draft=self.native_draft,
                                            n_threads=nt)
            return [imgs[j] if st[j] == 0 else
                    load_image(self._path(idx), self.image_size, False)
                    for j, (idx, _) in enumerate(tasks)]
        # the PIL path's RNG use: reseed per sample, draw the crop box and
        # the flip, then decode the batch. An image whose 10 box draws all
        # fail takes center_crop_resize in the PIL path, so it goes
        # through the eval transform here (then the flip)
        boxes = np.zeros((len(tasks), 4), dtype=np.int32)
        flips = np.zeros(len(tasks), dtype=np.int32)
        box_idx, eval_idx = [], []
        for j, ((_, sample_seed), buf) in enumerate(zip(tasks, bufs)):
            wh = nl.probe(buf)
            if wh is None:
                continue  # status stays -1: PIL below
            rng = np.random.RandomState(sample_seed)
            box = draw_crop_box(wh[0], wh[1], rng)
            flips[j] = int(rng.rand() < 0.5)
            if box is None:
                eval_idx.append(j)
            else:
                boxes[j] = box
                box_idx.append(j)
        size = self.image_size
        imgs = np.empty((len(tasks), size, size, 3), dtype=np.uint8)
        st = np.full(len(tasks), -1, dtype=np.int32)
        if box_idx:
            imgs[box_idx], st[box_idx] = nl.decode_train_batch(
                [bufs[j] for j in box_idx], boxes[box_idx], flips[box_idx],
                size, n_threads=nt)
        if eval_idx:
            out_e, st_e = nl.decode_eval_batch(
                [bufs[j] for j in eval_idx], size, draft=False,
                n_threads=nt)
            for pos, j in enumerate(eval_idx):
                imgs[j] = out_e[pos][:, ::-1] if flips[j] else out_e[pos]
                st[j] = st_e[pos]
        out = []
        for j, (idx, sample_seed) in enumerate(tasks):
            if st[j] != 0:
                self.rng = np.random.RandomState(sample_seed)
                out.append(load_image(self._path(idx), size, True, self.rng))
            else:
                out.append(imgs[j])
        return out

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.get_sample(idx)

    def get_sample(self, idx: int, image=None) -> Dict[str, Any]:
        """Assemble one sample; ``image`` may be given already decoded
        (:meth:`decode_chunk`), with ``device_resize`` as (canvas, side)."""
        ex = self.examples[idx]
        if image is None and self.native_loader:
            image = self._load_native_one(self._path(idx))
        if image is None:
            image = (load_image_square(self._path(idx), self.image_size,
                                       self.canvas_size)
                     if self.device_resize else
                     load_image(self._path(idx), self.image_size,
                                self.is_training, self.rng))
        side = None
        if isinstance(image, tuple):
            image, side = image
        if self.is_training:
            ids, mask = self.tokenizer.encode(ex["caption"], self.max_length)
            return {
                "image": image,
                "caption_tokens": ids,
                "attention_mask": mask,
                "caption": ex["caption"],
                "image_id": ex["image_id"],
            }
        # eval: all references, padded to a fixed count (SURVEY.md §2.4 fix)
        R = self.max_ref_captions
        caps = ex["captions"][:R]
        ids = np.zeros((R, self.max_length), dtype=np.int32)
        mask = np.zeros((R, self.max_length), dtype=np.int32)
        ref_mask = np.zeros(R, dtype=np.int32)
        for i, cap in enumerate(caps):
            ids[i], mask[i] = self.tokenizer.encode(cap, self.max_length)
            ref_mask[i] = 1
        sample = {
            "image": image,
            "caption_tokens": ids,
            "attention_mask": mask,
            "ref_mask": ref_mask,
            "captions": ex["captions"],
            "image_id": ex["image_id"],
        }
        if side is not None:
            sample["image_size"] = side
        return sample

    def caption_lengths(self) -> np.ndarray:
        """Token lengths per example (curriculum difficulty input,
        reference: src/train/curriculum.py:82-98). Training mode only."""
        return np.array(
            [len(ex["caption"].split()) for ex in self.examples], dtype=np.int32)


class ObjectDetectionFeaturesDataset:
    """Pre-extracted detector features (an ``.npz`` of ``features`` and
    ``boxes`` per image id), padded or truncated to ``max_objects`` with
    the valid regions in ``region_mask``; a file that fails to load gives
    zeros and an all-False mask (the reference's behaviour)."""

    def __init__(self, features_dir: str, annotation_file: str, tokenizer,
                 max_objects: int = 36, max_length: int = 50,
                 is_training: bool = True, feature_dim: int = 2048,
                 max_ref_captions: int = 5):
        self.features_dir = features_dir
        self.tokenizer = tokenizer
        self.max_objects = max_objects
        self.max_length = max_length
        self.is_training = is_training
        self.feature_dim = feature_dim
        self.max_ref_captions = max_ref_captions
        with open(annotation_file) as f:
            self.annotations = json.load(f)
        self.image_id_to_filename = {
            img["id"]: f"{img['id']}.npz" for img in self.annotations["images"]
        }
        self.examples = build_caption_examples(
            self.annotations["annotations"], self.image_id_to_filename,
            is_training)

    def __len__(self):
        return len(self.examples)

    def _load_features(self, filename: str):
        N, D = self.max_objects, self.feature_dim
        feats = np.zeros((N, D), dtype=np.float32)
        boxes = np.zeros((N, 4), dtype=np.float32)
        mask = np.zeros(N, dtype=bool)
        try:
            data = np.load(os.path.join(self.features_dir, filename),
                           allow_pickle=True)
            f, b = data["features"], data["boxes"]
            n = min(f.shape[0], N)
            feats[:n] = f[:n]
            boxes[:n] = b[:n]
            mask[:n] = True
        except Exception as e:  # zero-fill
            print(f"Error loading features for {filename}: {e}")
        return feats, boxes, mask

    def num_objects(self) -> np.ndarray:
        """The detected-object count of each example, from its region mask
        (the curriculum's ``num_objects`` difficulty); each file read
        once."""
        counts: Dict[str, int] = {}
        for ex in self.examples:
            fn = ex["filename"]
            if fn not in counts:
                counts[fn] = int(self._load_features(fn)[2].sum())
        return np.array([counts[ex["filename"]] for ex in self.examples],
                        dtype=np.int32)

    def caption_lengths(self) -> np.ndarray:
        """Word counts per training caption (the curriculum's
        difficulty)."""
        return np.array(
            [len(ex["caption"].split()) for ex in self.examples
             if "caption" in ex] or [0], dtype=np.int32)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        ex = self.examples[idx]
        feats, boxes, mask = self._load_features(ex["filename"])
        base = {"region_features": feats, "region_boxes": boxes,
                "region_mask": mask, "image_id": ex["image_id"]}
        if self.is_training:
            ids, amask = self.tokenizer.encode(ex["caption"], self.max_length)
            return dict(base, caption_tokens=ids, attention_mask=amask,
                        caption=ex["caption"])
        R = self.max_ref_captions
        ids = np.zeros((R, self.max_length), dtype=np.int32)
        amask = np.zeros((R, self.max_length), dtype=np.int32)
        ref_mask = np.zeros(R, dtype=np.int32)
        for i, cap in enumerate(ex["captions"][:R]):
            ids[i], amask[i] = self.tokenizer.encode(cap, self.max_length)
            ref_mask[i] = 1
        return dict(base, caption_tokens=ids, attention_mask=amask,
                    ref_mask=ref_mask, captions=ex["captions"])


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

_STACK_KEYS = {"image", "caption_tokens", "attention_mask", "ref_mask",
               "region_features", "region_boxes", "region_mask", "image_id",
               "image_size"}


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array fields; keep strings/lists as Python lists."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        if k in _STACK_KEYS:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


def iterate_batches(dataset, batch_size: int, shuffle: bool = False,
                    drop_last: bool = True,
                    sampler: Optional[Iterator[int]] = None,
                    seed: int = 0,
                    pad_last: bool = False,
                    num_workers: int = 0,
                    skip_batches: int = 0,
                    rows: Optional[slice] = None
                    ) -> Iterator[Dict[str, Any]]:
    """Yield fixed-shape batches. ``sampler`` (e.g. the curriculum sampler)
    overrides shuffling (reference: src/data/dataset.py:445-462).

    ``pad_last=True`` pads the final short batch by repeating its last
    sample (static shapes for XLA) and adds a ``batch_valid`` bool mask so
    eval loops can cover every example without recompilation.

    ``num_workers > 0`` loads samples through a fork-based process pool —
    the equivalent of the reference's torch DataLoader workers
    (reference: src/data/dataset.py:452). PIL decode barely scales with
    threads on this stack (measured: 16 threads gave 1.1x), so workers are
    processes inheriting the dataset via fork. Worker tasks reseed the
    dataset's augmentation RNG per sample from ``(seed, index)``, torch
    DataLoader style: results are deterministic for a given ``seed`` and
    independent of the worker count (callers already mix the epoch into
    ``seed``, so augmentations still vary across epochs).

    ``skip_batches`` skips the first k chunks of the (identically seeded)
    index order without loading them — mid-epoch checkpoint resume replays
    the exact remaining batch sequence at zero decode cost.

    ``rows`` (one rank's slice of a batch,
    :func:`..parallel.mesh.batch_rows`) loads only those rows of each
    batch: its array fields, ``batch_valid`` included, are the slice's,
    while its list fields (the captions) stay the whole batch's, read from
    the examples without decoding, as the JAX package shards only the
    arrays of a batch over its mesh."""
    if sampler is not None:
        indices = list(sampler)
    else:
        indices = list(range(len(dataset)))
        if shuffle:
            np.random.RandomState(seed).shuffle(indices)

    pool = None
    if num_workers and num_workers > 0:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # Bind THIS dataset to the pool at construction: with the fork
        # context, ``initargs`` is a live reference held by the executor, so
        # even a lazily-forked worker (ProcessPoolExecutor spawns workers on
        # demand) calls _set_ds(dataset) in the child — two concurrently
        # consumed iterators can't cross-wire through a shared global.
        pool = ProcessPoolExecutor(
            max_workers=num_workers, mp_context=mp.get_context("fork"),
            initializer=_set_ds, initargs=(dataset,))
    try:
        for start in range(skip_batches * batch_size, len(indices),
                           batch_size):
            chunk = indices[start:start + batch_size]
            valid = len(chunk)
            if valid < batch_size:
                if pad_last:
                    chunk = chunk + [chunk[-1]] * (batch_size - valid)
                elif drop_last:
                    return
            tasks = [(i, (seed * 1_000_003 + i) & 0x7FFFFFFF)
                     for i in (chunk if rows is None else chunk[rows])]
            if pool is not None:
                samples = list(pool.map(
                    _worker_get, tasks,
                    chunksize=max(1, len(tasks) // num_workers)))
            elif getattr(dataset, "native_loader", False) and (
                    decoded := dataset.decode_chunk(tasks)) is not None:
                # the native batch decode: one call for the whole chunk,
                # threads inside, the same per-sample seeding
                samples = [dataset.get_sample(i, image=img)
                           for (i, _), img in zip(tasks, decoded)]
            else:
                # same per-sample seeding as the worker path, so batches are
                # identical for any worker count (incl. 0); no module global
                # here — interleaved serial iterators stay independent
                reseed = getattr(dataset, "rng", None) is not None
                samples = []
                for i, sample_seed in tasks:
                    if reseed:
                        dataset.rng = np.random.RandomState(sample_seed)
                    samples.append(dataset[i])
            batch = collate(samples)
            if rows is not None:
                batch.update(collate([_list_fields(dataset, i)
                                      for i in chunk]))
            if pad_last:
                mask = np.zeros(batch_size, dtype=bool)
                mask[:valid] = True
                batch["batch_valid"] = mask if rows is None else mask[rows]
            yield batch
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


def _list_fields(dataset, idx: int) -> Dict[str, Any]:
    """A sample's list fields from its example, with no decode: a training
    sample's caption, an eval sample's references."""
    ex = dataset.examples[idx]
    return ({"caption": ex["caption"]} if dataset.is_training
            else {"captions": ex["captions"]})


_WORKER_DATASET = None


def _set_ds(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(task):
    """Fetch one sample with a per-sample augmentation RNG.

    Used by both the serial path and the forked process-pool workers (each
    worker runs tasks single-threaded, so reseeding its copy of the
    dataset RNG per task is race-free)."""
    idx, sample_seed = task
    ds = _WORKER_DATASET
    if getattr(ds, "rng", None) is not None:
        ds.rng = np.random.RandomState(sample_seed)
    return ds[idx]


def build_coco_datasets(config, tokenizer):
    """Train/val dataset pair from a Config
    (reference: build_coco_dataloaders, src/data/dataset.py:390-472)."""
    native = dict(
        native_loader=getattr(config, "native_loader", False),
        native_threads=getattr(config, "native_threads", 0),
        native_draft=getattr(config, "native_draft", False),
    )
    train = COCOCaptionDataset(
        root_dir=config.data_root,
        annotation_file=config.train_json,
        image_dir=config.train_image_dir,
        tokenizer=tokenizer,
        image_size=config.image_size,
        max_length=config.model.decoder.max_length,
        is_training=True,
        seed=config.seed,
        **native,
    )
    val = COCOCaptionDataset(
        root_dir=config.data_root,
        annotation_file=config.val_json,
        image_dir=config.val_image_dir,
        tokenizer=tokenizer,
        image_size=config.image_size,
        max_length=config.model.decoder.max_length,
        is_training=False,
        seed=config.seed,
        device_resize=getattr(config, "device_resize", False),
        **native,
    )
    return train, val


def build_object_datasets(config, tokenizer):
    """Train/val pair over pre-extracted detector features under
    ``data_root/features_dir`` (the object-region path)."""
    feats = os.path.join(config.data_root, config.features_dir)
    common = dict(features_dir=feats, tokenizer=tokenizer,
                  max_objects=config.model.encoder.max_objects,
                  max_length=config.model.decoder.max_length,
                  feature_dim=config.model.encoder.region_feature_dim)
    train = ObjectDetectionFeaturesDataset(
        annotation_file=os.path.join(config.data_root, config.train_json),
        is_training=True, **common)
    val = ObjectDetectionFeaturesDataset(
        annotation_file=os.path.join(config.data_root, config.val_json),
        is_training=False, **common)
    return train, val
