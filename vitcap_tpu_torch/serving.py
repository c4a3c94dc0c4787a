"""Dynamic-batching caption server, the port of vitcap_tpu/serving.py.

`CaptionServer` accepts single-image requests from any number of client
threads, groups them into fixed-size batches (padding the tail by repeating
the last row: greedy, sampled and beam decode are row-independent, so
padding never changes real rows), keeps up to `max_in_flight` batches
queued on the device so host preparation overlaps device work, and resolves
each request's Future.  With num_keep_best > 1 (beams) or
num_return_sequences > 1 a request resolves with the first of its rows.
The engine is chosen as generate chooses it (VITCAP_DECODE_FUSED=1: the
fused decode step).

    server = CaptionServer(model, cfg, tokenizer=CaptionDecoder(),
                           batch_size=16)
    fut = server.submit(image_hwc)          # any thread
    print(fut.result()["caption"])
    server.close()
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np
import torch

from .models import decode as D

__all__ = ["CaptionServer"]


class CaptionServer:
    """Fixed-shape dynamic batcher over the cached decode engine.

    model, cfg : the ViTCAP module (its parameters' device is the serving
        device) and its ModelConfig.
    opts : DecodeOptions (default: greedy at cfg.max_gen_length); beams,
        sampling and the other options as generate takes them.
    tokenizer : optional object with decode(ids, skip_special_tokens=True)
        (e.g. data.tokenization.CaptionDecoder); futures then resolve with
        {"caption": str, "conf": float}, else {"ids", "logprob"}.
    batch_size : static device batch.
    max_delay_s : how long the batcher waits for more requests after the
        first one before dispatching a partial batch.
    max_in_flight : device batches outstanding before the batcher blocks
        on the oldest.
    seed : seeds the torch.Generator, on the serving device, that sampling
        draws from (greedy and plain beam search draw nothing).
    """

    def __init__(self, model, cfg, opts=None, tokenizer=None,
                 batch_size: int = 16, max_delay_s: float = 0.005,
                 max_in_flight: int = 2, seed: int = 0):
        if opts is None:
            opts = D.DecodeOptions(max_length=cfg.max_gen_length,
                                   od_labels_start_posid=cfg.max_seq_a_len)
        self.cfg = cfg
        self.opts = opts
        self.tokenizer = tokenizer
        self.batch_size = int(batch_size)
        self.max_delay_s = float(max_delay_s)
        self.max_in_flight = max(1, int(max_in_flight))
        self._model = model
        self.device = next(model.parameters()).device
        od_len = cfg.max_seq_len - cfg.max_seq_a_len
        self._od_ids = torch.zeros(self.batch_size, od_len, dtype=torch.long,
                                   device=self.device)
        self._seq_len = torch.full((self.batch_size,), cfg.max_seq_a_len,
                                   dtype=torch.long, device=self.device)
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()
        self.n_requests = 0
        self.n_batches = 0
        self._fill_sum = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="caption-server-batcher")
        self._thread.start()

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------

    def submit(self, image: np.ndarray) -> "Future":
        """Enqueue one (H, W, 3) image; returns a Future.  Any size whose
        patch grid is square serves (the pos-embed is resized to it, e.g.
        512 px against a 384-px model); the requests of one batch share
        it.  uint8 (raw resized RGB bytes) is the recommended feed: the
        normalisation folds into the patch projection on the device.  Float
        inputs must already be (x/255 - mean)/std normalised."""
        if self._closed.is_set():
            raise RuntimeError("CaptionServer is closed")
        image = np.asarray(image)
        if image.ndim != 3:
            raise ValueError(f"expected (H, W, 3) image, got {image.shape}")
        fut: Future = Future()
        self._queue.put((image, fut))
        return fut

    def caption(self, image: np.ndarray,
                timeout: Optional[float] = None) -> Dict[str, Any]:
        """Synchronous single-image convenience wrapper."""
        return self.submit(image).result(timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        return {
            "requests": self.n_requests,
            "batches": self.n_batches,
            "mean_fill": (self._fill_sum / self.n_batches
                          if self.n_batches else 0.0),
            "batch_size": self.batch_size,
        }

    def close(self, timeout: float = 30.0) -> None:
        """Drain pending requests and stop the batcher thread."""
        if not self._closed.is_set():
            self._closed.set()
            self._queue.put(None)            # wake the batcher
            self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # batcher loop
    # ------------------------------------------------------------------

    def _fill(self, items):
        """Wait up to max_delay_s for the batch to fill past the first
        request.  Returns (items, stop)."""
        deadline = time.monotonic() + self.max_delay_s
        stop = False
        while len(items) < self.batch_size:
            rest = deadline - time.monotonic()
            if rest <= 0:
                break
            try:
                nxt = self._queue.get(timeout=rest)
            except queue.Empty:
                break
            if nxt is None:
                stop = True
                break
            items.append(nxt)
        return items, stop

    def _dispatch(self, items):
        B = self.batch_size
        n = len(items)
        images = np.stack([im for im, _ in items], axis=0)
        if n < B:                            # pad by repeating the last
            pad = np.repeat(images[-1:], B - n, axis=0)
            images = np.concatenate([images, pad], axis=0)
        if images.dtype != np.uint8:         # uint8 feeds stay uint8
            images = images.astype(np.float32)
        images = torch.from_numpy(images).to(self.device, non_blocking=True)
        out = D.generate(self._model, images, self._od_ids, None,
                         self._seq_len, self.cfg, self.opts, self._generator)
        self.n_batches += 1
        self._fill_sum += n
        return ([f for _, f in items], n, out["ids"], out["logprobs"])

    def _resolve(self, pending):
        futures, n, ids, lp = pending
        try:
            ids = ids[:n].cpu().numpy()      # waits for the batch; a device
            lp = lp[:n].float().cpu().numpy()   # fault surfaces here
        except Exception as e:               # resolve, don't kill serving
            logging.exception("caption batch failed on the device")
            for fut in futures:
                if not fut.cancelled():
                    fut.set_exception(e)
            return
        for i, fut in enumerate(futures):
            if fut.cancelled():
                continue
            row_ids = ids[i].reshape(-1, ids.shape[-1])[0]
            row_lp = float(lp[i].reshape(-1)[0])
            if self.tokenizer is not None:
                fut.set_result({
                    "caption": self.tokenizer.decode(
                        row_ids.tolist(), skip_special_tokens=True),
                    "conf": float(np.exp(row_lp)),
                })
            else:
                fut.set_result({"ids": row_ids, "logprob": row_lp})

    def _loop(self):
        in_flight = []
        stop = False
        while not stop:
            # never hold a completed batch while blocking for new work
            if in_flight:
                try:
                    first = self._queue.get(timeout=0.0005)
                except queue.Empty:
                    self._resolve(in_flight.pop(0))
                    continue
            else:
                first = self._queue.get()
            if first is None:
                break
            items, stop = self._fill([first])
            if items:
                try:
                    in_flight.append(self._dispatch(items))
                    self.n_requests += len(items)
                except Exception as e:        # resolve, don't kill serving
                    logging.exception("caption batch failed")
                    for _, fut in items:
                        if not fut.cancelled():
                            fut.set_exception(e)
                while len(in_flight) >= self.max_in_flight:
                    self._resolve(in_flight.pop(0))
            if stop or (self._closed.is_set() and self._queue.empty()):
                break
        while in_flight:
            self._resolve(in_flight.pop(0))
        # fail anything that raced in after close()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("server closed"))
