"""Streaming image/mask datasets (segmentation_tpu.data.datasets).

A host-side pool of decode/crop worker threads fills a bounded buffer; a
reorder buffer serves the samples in one global paired-shuffled order, so
a fixed seed gives the same batches whatever the thread timing, and the
same batches as the JAX package's datasets on the same files:

  - sorted-glob image/mask pairing, with a warning when stems differ;
  - epoch e visits the pairs in ``default_rng(seed + e).permutation``;
    sample i crops with ``default_rng(SeedSequence([seed, i]))``;
  - one task decodes both files of a pair, so pairing cannot break;
  - an unreadable file leaves a sentinel that the reorder buffer skips.

Batches are numpy dicts, images f32 /255 and masks u8 class indices
(``DevicePrefetcher`` moves them to the card). ``MNISTDataSet`` is not
ported yet.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from segmentation_tpu_torch.data.augment import host_joint_random_crop
from segmentation_tpu_torch.data.decode import decode_image


def load_images(paths: Sequence[str], batchsize: int, crop_size: int,
                seed: Optional[int] = None) -> np.ndarray:
    """Eager batch loader for inference: random-choice files, RGB decode,
    per-image random crop, stack, /255."""
    rng = np.random.default_rng(seed)
    chosen = rng.choice(list(paths), batchsize)
    out = []
    for p in chosen:
        img = decode_image(p)
        img, _ = host_joint_random_crop(rng, img, None, crop_size)
        out.append(img)
    return np.stack(out).astype(np.float32) / 255.0


def _resize_by_ratio(img: np.ndarray, mask: Optional[np.ndarray],
                     ratio: float):
    """Decode-time downscale after the crop: images bilinear, masks
    nearest (labels must not blend)."""
    if ratio == 1.0:
        return img, mask
    h, w = img.shape[:2]
    oh, ow = max(1, int(round(h * ratio))), max(1, int(round(w * ratio)))
    mask_had_channel = mask is not None and mask.ndim == 3
    try:
        import cv2

        img = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        if mask is not None:
            mask = cv2.resize(mask, (ow, oh),
                              interpolation=cv2.INTER_NEAREST)
    except ImportError:
        from PIL import Image

        img = np.asarray(
            Image.fromarray(img).resize((ow, oh), Image.BILINEAR)
        )
        if mask is not None:
            mask = np.asarray(
                Image.fromarray(np.squeeze(mask)).resize(
                    (ow, oh), Image.NEAREST
                )
            )
    if mask_had_channel and mask.ndim == 2:  # cv2/PIL drop the [...,1] dim
        mask = mask[..., None]
    return img, mask


class _ThreadedPairLoader:
    """Worker pool: draws (image, mask) path pairs in paired-shuffled order,
    decodes + crops on the host (masks decoded as grayscale), and fills a
    bounded buffer of ``capacity`` samples."""

    def __init__(
        self,
        image_names: List[str],
        mask_names: Optional[List[str]],
        crop_size: int,
        capacity: int,
        threads: int,
        seed: int,
        augment_flip: bool,
        ratio: float = 1.0,
    ):
        self.image_names = image_names
        self.mask_names = mask_names
        self.crop_size = crop_size
        self.capacity = max(capacity, 2)
        self.threads = max(1, threads)
        self.seed = seed
        self.augment_flip = augment_flip
        self.ratio = ratio

        self._buffer: "queue.Queue" = queue.Queue(maxsize=self.capacity)
        self._stop = threading.Event()
        self._started = False
        # the global sample counter: index i is claimed by whichever
        # worker increments it, and decoded with its own rng
        self._counter = 0
        self._counter_lock = threading.Lock()
        self._reorder: Dict[int, tuple] = {}
        self._next_serve = 0

    def _pair_at(self, global_idx: int):
        n = len(self.image_names)
        epoch, i = divmod(global_idx, n)
        perm = np.random.default_rng(self.seed + epoch).permutation(n)
        j = int(perm[i])
        return (
            self.image_names[j],
            self.mask_names[j] if self.mask_names is not None else None,
        )

    def _next_index(self) -> int:
        with self._counter_lock:
            idx = self._counter
            self._counter += 1
        return idx

    def _work(self, worker_id: int):
        while not self._stop.is_set():
            idx = self._next_index()
            img_path, mask_path = self._pair_at(idx)
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, idx])
            )
            try:
                img = decode_image(img_path)
                mask = (
                    decode_image(mask_path, grayscale=True)
                    if mask_path is not None
                    else None
                )
                img, mask = host_joint_random_crop(
                    rng, img, mask, self.crop_size, flip=self.augment_flip
                )
                img, mask = _resize_by_ratio(img, mask, self.ratio)
            except Exception as e:  # unreadable file → sentinel keeps the
                # global-order reorder buffer gap-free
                print(f"[data] worker {worker_id}: skipping {img_path}: {e}")
                img, mask = None, None
            item = (idx, img, mask)
            while not self._stop.is_set():
                try:
                    self._buffer.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def start(self):
        if self._started:
            return
        self._started = True
        for t in range(self.threads):
            threading.Thread(
                target=self._work, args=(t,), daemon=True,
                name=f"seg-data-{t}",
            ).start()

    def stop(self):
        self._stop.set()
        try:  # drain so workers blocked on put() can exit
            while True:
                self._buffer.get_nowait()
        except queue.Empty:
            pass

    def take(self, n: int):
        """The next n samples in global paired-shuffled order, decode
        failures skipped."""
        if not self._started:
            self.start()
        out = []
        while len(out) < n:
            while self._next_serve not in self._reorder:
                idx, img, mask = self._buffer.get()
                self._reorder[idx] = (img, mask)
            img, mask = self._reorder.pop(self._next_serve)
            if img is not None:
                out.append((self._next_serve, img, mask))
            self._next_serve += 1
        return out


class ImageMaskDataSet:
    """Paired image/mask streaming dataset."""

    has_masks = True

    def __init__(
        self,
        image_dir: str,
        mask_dir: str,
        image_names: Optional[Sequence[str]] = None,
        mask_names: Optional[Sequence[str]] = None,
        n_classes: int = 2,
        batch_size: int = 96,
        crop_size: int = 256,
        ratio: float = 1.0,
        capacity: int = 5000,
        image_ext: str = "jpg",
        mask_ext: str = "png",
        seed: int = 5555,
        threads: int = 4,
        augment_flip: bool = False,
        mask_divisor: Optional[int] = 255,
    ):
        if image_names is None:
            image_names = sorted(
                glob.glob(os.path.join(image_dir, f"*.{image_ext}"))
            )
        if mask_names is None:
            mask_names = sorted(
                glob.glob(os.path.join(mask_dir, f"*.{mask_ext}"))
            )
        image_names = list(image_names)
        mask_names = list(mask_names)
        if not image_names:
            raise ValueError(f"no *.{image_ext} files in {image_dir}")
        if len(image_names) != len(mask_names):
            raise ValueError(
                f"{len(image_names)} images vs {len(mask_names)} masks — "
                "sorted-glob pairing requires equal counts"
            )
        mismatched = sum(
            1
            for a, b in zip(image_names, mask_names)
            if os.path.splitext(os.path.basename(a))[0]
            != os.path.splitext(os.path.basename(b))[0]
        )
        if mismatched:
            print(
                f"[data] WARNING: {mismatched}/{len(image_names)} image/mask "
                "stems differ — verify the sorted-glob pairing is intended"
            )
        self.image_names = image_names
        self.mask_names = mask_names
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.ratio = ratio
        self.n_classes = n_classes
        # 0/255 binary masks divide to {0, 1}; None keeps class indices
        self.mask_divisor = mask_divisor
        self._loader = _ThreadedPairLoader(
            image_names, mask_names, crop_size, capacity, threads, seed,
            augment_flip, ratio=ratio,
        )

    def stop(self):
        self._loader.stop()

    def get_batch(self) -> Dict[str, np.ndarray]:
        items = self._loader.take(self.batch_size)
        imgs = np.stack([im for _, im, _ in items]).astype(np.float32) / 255.0
        masks = np.stack([mk for _, _, mk in items]).astype(np.int32)
        if self.mask_divisor:
            masks = masks // self.mask_divisor
        return {
            "image": imgs,
            "mask": np.clip(masks, 0, self.n_classes - 1).astype(np.uint8),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.get_batch()


class ImageDataSet:
    """Image-only streaming dataset."""

    has_masks = False

    def __init__(
        self,
        image_dir: str,
        n_classes: int = 2,
        batch_size: int = 96,
        crop_size: int = 256,
        ratio: float = 1.0,
        capacity: int = 2000,
        image_ext: str = "jpg",
        seed: int = 5555,
        threads: int = 4,
        augment_flip: bool = False,
    ):
        image_names = sorted(
            glob.glob(os.path.join(image_dir, f"*.{image_ext}"))
        )
        if not image_names:
            raise ValueError(f"no *.{image_ext} files in {image_dir}")
        self.image_names = image_names
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.n_classes = n_classes
        self.ratio = ratio
        self._loader = _ThreadedPairLoader(
            image_names, None, crop_size, capacity, threads, seed,
            augment_flip, ratio=ratio,
        )

    def stop(self):
        self._loader.stop()

    def get_batch(self) -> Dict[str, np.ndarray]:
        items = self._loader.take(self.batch_size)
        imgs = np.stack([im for _, im, _ in items]).astype(np.float32) / 255.0
        return {"image": imgs}

    def __iter__(self):
        while True:
            yield self.get_batch()
