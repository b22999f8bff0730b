"""Batched, sharded, prefetching data loader.

Replaces torch ``DataLoader`` + ``DistributedSampler`` / ``RandomSampler`` /
``SequentialSampler`` (reference src/utils/semi_dataset.py:326-362,
src/algorithms/base.py:355-357) with a host-side NumPy loader that shards over
data-parallel replicas:

- **Device-granular sharding.** ``batch_size`` keeps the reference meaning
  (*per data-parallel replica*), so the loader yields *global* batches of
  ``batch_size × data_parallel_size`` laid out replica-major, so each
  replica's rows are one contiguous slice. Epoch lengths match torch's DistributedSampler+drop_last math
  (pad-to-divisible with wraparound, ``rank:total:world`` striding).
- **set_epoch built in.** Shuffling and every augmentation draw derive from
  ``(seed, epoch, index)`` Philox streams — the reference's
  ``sampler.set_epoch`` discipline without mutable sampler state.
- **Thread or process workers.** A background pool maps the (NumPy,
  GIL-releasing scipy) per-sample pipeline and a prefetch queue keeps ready
  batches ahead of the step (torch ``num_workers`` parity). Threads are the
  default; ``worker_type: process`` forks real worker processes — the
  mechanism the reference's torch DataLoader uses — for multi-core hosts
  where the Python fraction of the pipeline is GIL-bound. Because every
  sample draw is a pure function of ``(seed, epoch, salt, index)``, both
  pools produce bit-identical batches.
"""

from __future__ import annotations

import logging
import math
import multiprocessing
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np


def _collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


# Process workers inherit the dataset by fork (never pickled): the Pool's
# initializer closure carries the dataset through the fork and rebinds this
# global *inside each worker*, exactly like torch's fork-mode DataLoader.
# Binding via the initializer (not a parent-side global) matters twice over:
# Pool respawns a crashed worker by forking the parent again and re-running
# the initializer, so the replacement always rebinds its own pool's dataset
# even when several pools coexist; and the parent process never pins a
# dataset reference beyond the pool's lifetime. Workers run only
# numpy/scipy/native code — they must never touch the device (a CUDA
# context does not survive a fork as a usable object).
_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch(args):
    seed, epoch, salt, idx = args
    rng = np.random.default_rng((seed, epoch, salt, idx))
    return _WORKER_DATASET.get(idx, rng=rng)


def epoch_indices(
    num_samples: int,
    shuffle: bool,
    seed: int,
    epoch: int,
    num_shards: int = 1,
) -> np.ndarray:
    """Global index order for one epoch, padded to a multiple of
    ``num_shards`` by wrapping (torch DistributedSampler parity)."""
    if shuffle:
        rng = np.random.default_rng((seed, epoch))
        indices = rng.permutation(num_samples)
    else:
        indices = np.arange(num_samples)
    total = int(math.ceil(num_samples / num_shards)) * num_shards
    if total > num_samples:
        # wrap as many times as needed (torch DistributedSampler repeats the
        # whole list): a single slice under-pads when the dataset is
        # smaller than the pad amount, leaving empty shards
        extra = total - num_samples
        reps = int(math.ceil(extra / num_samples))
        indices = np.concatenate([indices, np.tile(indices, reps)[:extra]])
    return indices


def _abandon_pool(pool, timeout: float = 5.0) -> None:
    """``terminate()+join()`` under a watchdog. A worker SIGKILLed (OOM
    killer) while holding a shared-queue lock leaves that POSIX semaphore
    permanently held, and ``Pool._terminate_pool`` then blocks forever
    draining the inqueue (``_help_stuff_finish``) — observed as a test
    deadlock. ``terminate()`` sets the pool state to
    TERMINATE synchronously (stopping worker respawns) before the hang
    point, so on timeout it is safe to SIGKILL the remaining workers and
    abandon the pool's daemon helper threads; the leaked semaphore dies
    with the process."""
    import os
    import signal

    done = threading.Event()

    def work():
        try:
            pool.terminate()
            pool.join()
        finally:
            done.set()

    threading.Thread(target=work, daemon=True).start()
    if done.wait(timeout):
        return
    logging.getLogger(__name__).warning(
        "worker pool terminate() wedged (a worker died holding a queue "
        "lock?) - killing its workers and abandoning it")
    for p in list(pool._pool):
        if p.is_alive() and p.pid is not None:
            try:
                os.kill(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


class DataLoader:
    """Iterate global batches of ``(batch_size * num_shards)`` samples.

    Per step, shard ``s`` owns rows ``[s*B:(s+1)*B]`` of the global batch;
    each shard walks its own strided slice of the epoch indices (parity with
    DistributedSampler's ``indices[rank:total:num_replicas]``).

    ``drop_last`` follows the reference default (True for train) —
    semi_dataset.py:354-356.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_shards: int = 1,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        shard_offset: int = 0,
        local_shards: Optional[int] = None,
        rng_salt: int = 0,
        worker_type: str = "thread",
        map_timeout: float = 120.0,
    ):
        if worker_type not in ("thread", "process"):
            raise ValueError(
                f"worker_type must be 'thread' or 'process', got "
                f"{worker_type!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        # multi-host: this process materialises shards
        # [shard_offset, shard_offset + local_shards)
        self.shard_offset = shard_offset
        self.local_shards = local_shards if local_shards is not None else num_shards
        self.rng_salt = rng_salt
        self.worker_type = worker_type
        # per-attempt ceiling for one process-pool map: a batch taking
        # longer than this with zero worker deaths is treated as a wedged
        # pool (see _process_map); re-running is free (pure draws), so a
        # false positive on a genuinely slow batch only costs time
        self.map_timeout = map_timeout
        self.epoch = 0
        self._pool = None
        self._pool_kind = None
        if self.worker_type == "process" and self.num_workers > 1:
            # fork eagerly, before any prefetch producer thread (or device
            # work) is live in this loader's lifetime — shrinks the
            # fork-with-locked-library-threads window to construction time
            self._ensure_pool()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _ensure_pool(self) -> None:
        if self._pool is not None or self.num_workers <= 1:
            return
        if self.worker_type == "process":
            try:
                ctx = multiprocessing.get_context("fork")
            except ValueError:  # non-POSIX: no fork start method
                logging.getLogger(__name__).warning(
                    "worker_type: process needs the fork start method, "
                    "unavailable on this platform - falling back to threads")
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
                self._pool_kind = "thread"
                return
            self._pool = ctx.Pool(self.num_workers, initializer=_worker_init,
                                  initargs=(self.dataset,))
            self._pool_kind = "process"
            # liveness baseline for _process_map: any later deviation (a
            # dead worker, or the pid swap its auto-respawn leaves behind)
            # marks the pool's shared queues as suspect
            self._pool_pids = {p.pid for p in self._pool._pool}
        else:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            self._pool_kind = "thread"

    def close(self) -> None:
        """Shut the worker pool down (persistent across epochs otherwise)."""
        pool, self._pool, self._pool_kind = self._pool, None, None
        if pool is None:
            return
        if isinstance(pool, ThreadPoolExecutor):
            pool.shutdown(wait=False)
        else:
            _abandon_pool(pool)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def samples_per_shard(self) -> int:
        return int(math.ceil(len(self.dataset) / self.num_shards))

    def __len__(self) -> int:
        n = self.samples_per_shard
        if self.drop_last:
            return n // self.batch_size
        return int(math.ceil(n / self.batch_size))

    def step_indices(self) -> np.ndarray:
        """(steps, local_shards, batch_size) dataset indices for this epoch.

        Without ``drop_last`` the final partial step wraps around to the head
        of the shard; evaluators use this matrix to scatter per-sample
        results back into dataset order (duplicates collapse, since eval is
        deterministic), which both de-duplicates padded rows and restores the
        sequential order the reference's ``.npy`` exports use.
        """
        indices = epoch_indices(
            len(self.dataset), self.shuffle, self.seed, self.epoch,
            self.num_shards,
        )
        per_shard = [
            indices[s::self.num_shards]
            for s in range(self.shard_offset, self.shard_offset + self.local_shards)
        ]
        steps = len(self)
        mat = np.empty((steps, self.local_shards, self.batch_size), dtype=np.int64)
        for j, shard in enumerate(per_shard):
            needed = steps * self.batch_size
            if needed > len(shard):
                reps = int(math.ceil(needed / len(shard)))
                shard = np.tile(shard, reps)
            mat[:, j, :] = shard[:needed].reshape(steps, self.batch_size)
        return mat

    def _produce(self, step_indices: np.ndarray) -> Dict[str, np.ndarray]:
        flat = step_indices.reshape(-1)
        epoch, seed, salt = self.epoch, self.seed, self.rng_salt

        def fetch(k: int) -> Dict[str, np.ndarray]:
            idx = int(flat[k])
            rng = np.random.default_rng((seed, epoch, salt, idx))
            return self.dataset.get(idx, rng=rng)

        if self._pool_kind == "process" and len(flat) > 1:
            # map preserves order; the (seed, epoch, salt, idx) key makes
            # the result identical to an in-process fetch
            samples = self._process_map(
                [(seed, epoch, salt, int(i)) for i in flat])
        elif self._pool is not None and len(flat) > 1:
            samples = list(self._pool.map(fetch, range(len(flat))))
        else:
            samples = [fetch(k) for k in range(len(flat))]
        return _collate(samples)

    def _process_map(self, args: List[tuple]) -> List[Dict[str, np.ndarray]]:
        """``Pool.map`` that survives killed workers.

        A worker SIGKILLed (OOM killer, crash in native code) while idle in
        ``inqueue.get()`` dies holding the queue's reader lock, deadlocking
        every other worker — and one killed mid-task loses that task, so a
        blocking ``map`` would hang forever either way. Instead: dispatch
        with ``map_async`` and poll; any change in the worker pid set (the
        Pool's maintenance thread respawns crashed workers, so death shows
        up as a pid swap) means queues may be corrupt and tasks lost —
        rebuild the pool from scratch and re-run the whole map, which is
        safe because every draw is a pure function of its args."""
        chunk = max(1, len(args) // (2 * self.num_workers))
        log = logging.getLogger(__name__)
        for attempt in range(3):
            result = self._pool.map_async(_worker_fetch, args,
                                          chunksize=chunk)
            deadline = time.monotonic() + self.map_timeout
            while True:
                try:
                    return result.get(timeout=0.2)
                except multiprocessing.TimeoutError:
                    # compare against the CREATION-time baseline, not a
                    # dispatch-time snapshot: a worker killed before this
                    # map was dispatched has already been pid-swapped by
                    # the Pool's maintenance thread, and the replacement
                    # inherits the same wedged queues
                    alive = {p.pid for p in self._pool._pool
                             if p.is_alive()}
                    if alive != self._pool_pids:
                        log.warning(
                            "loader worker died mid-epoch (attempt %d) - "
                            "rebuilding the process pool and re-running "
                            "the batch", attempt + 1)
                        self.close()
                        self._ensure_pool()
                        break  # next attempt re-dispatches on a fresh pool
                    if time.monotonic() > deadline:
                        # escape hatch for a wedge the pid check cannot
                        # see: rebuilding re-forks from a by-now
                        # multithreaded parent, and a child that inherited
                        # a held lock deadlocks WITHOUT dying - no pid
                        # swap, no result, forever. Rather than hang the
                        # step loop, declare the attempt dead.
                        log.warning(
                            "loader map produced nothing for %.0f s with "
                            "all workers nominally alive (attempt %d) - "
                            "rebuilding the pool", self.map_timeout,
                            attempt + 1)
                        self.close()
                        self._ensure_pool()
                        break
        raise RuntimeError(
            "loader process workers keep dying; giving up after 3 pool "
            "rebuilds (is dataset.get crashing its worker?)")

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        mat = self.step_indices()
        self._ensure_pool()
        if self.prefetch <= 1 or len(mat) <= 1:
            for step in range(len(mat)):
                yield self._produce(mat[step])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def _put(item) -> bool:
            """Blocking put that gives up if the consumer went away (a
            plain q.put would pin this thread forever on an abandoned
            iterator)."""
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for step in range(len(mat)):
                    if not _put(self._produce(mat[step])):
                        return
            except BaseException as exc:  # propagate, don't truncate
                _put(("__loader_error__", exc))
            finally:
                _put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == "__loader_error__":
                    # a data-pipeline failure must fail the epoch, not
                    # silently shorten it
                    raise item[1]
                yield item
            t.join()
        finally:
            abandoned.set()
            while not q.empty():  # unblock a producer stuck on put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def get_dataloader(
    dataset,
    is_distributed: bool = False,
    dist_eval: bool = False,
    mode: str = "train",
    batch_size: int = 1,
    seed: int = 0,
    num_shards: int = 1,
    shard_offset: int = 0,
    local_shards: Optional[int] = None,
    rng_salt: int = 0,
    num_workers: int = 4,
    drop_last: Optional[bool] = None,
    worker_type: str = "thread",
    **_ignored,
) -> DataLoader:
    """Reference-compatible loader factory (semi_dataset.py:326-362).

    Differences by design: evaluation is *always* sharded over the mesh
    (each device sees a disjoint slice; padded rows are masked out by the
    evaluator) instead of the reference's every-rank-evaluates-everything
    fallback, which produced ×world_size duplicated gather traffic
    (semi_dataset.py:334 note in SURVEY §2 ⑯).
    """
    is_train = mode == "train"
    if drop_last is None:
        drop_last = is_train
    shuffle = is_train  # eval keeps deterministic order for .npy export parity
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle,
        seed=seed,
        num_shards=num_shards,
        drop_last=drop_last,
        num_workers=num_workers,
        shard_offset=shard_offset,
        local_shards=local_shards,
        rng_salt=rng_salt,
        worker_type=worker_type,
    )
