"""The port's worker-process loader (tdrn_tpu_torch/data/process_loader.py):

  * its batch stream for a seed bit-equal to the thread loader's
    (data/loader.py, itself equal to the JAX package's) at 0 and 2 workers,
    on a mini VOC (frame mode) and a mini VID (clip mode, (T, B, ...)), over
    an epoch boundary;
  * its (rank, world) shards: ranks 0 and 1 of 2 concatenated equal the
    one-process batch;
  * its batch contract (leaves, dtypes, shapes, the clip layout) equal to
    the JAX package's grain loader (make_grain_loader) on the same data;
  * a worker's exception raised again in the consumer, and no worker alive
    after close().
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from tdrn_tpu.data import augment as jaug
from tdrn_tpu.data import vid as jvid
from tdrn_tpu.data import voc as jvoc
from tdrn_tpu.data.grain_pipeline import make_grain_loader
from tdrn_tpu_torch.data import augment as taug
from tdrn_tpu_torch.data import vid as tvid
from tdrn_tpu_torch.data import voc as tvoc
from tdrn_tpu_torch.data.loader import make_loader
from tdrn_tpu_torch.data.process_loader import make_process_loader
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_train_data import _write_vid, _write_voc

SIZE = 64


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("process_loader")
    rng = np.random.default_rng(31)
    _write_voc(str(base / "voc"), rng)
    _write_vid(str(base / "vid"), rng)
    return dict(voc=str(base / "voc"), vid=str(base / "vid"))


def _datasets(data, clip, pkg_voc=tvoc, pkg_vid=tvid, aug=taug):
    """(dataset, batch size, batches to cross an epoch) in frame or clip mode."""
    a = aug.SSDAugmentation(SIZE, seed=4)
    if clip:  # 3 snippets: 2 clips a batch cross an epoch every 1.5 batches
        return pkg_vid.VIDDetection(data["vid"], "train", mode="clip", seq_len=2, transform=a,
                                    seed=1), 2, 3
    # 5 images: batches of 2 cross the epoch at the third batch
    return pkg_voc.VOCDetection(data["voc"], image_sets=(("2007", "trainval"),), transform=a,
                                seed=1), 2, 4


def _close(loader):
    pids = loader.worker_pids
    loader.close()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)  # joined and reaped by close()


@pytest.mark.parametrize("clip", [False, True], ids=["frames", "clips"])
@pytest.mark.parametrize("workers", [0, 2])
def test_stream_equals_thread_loader(data, clip, workers):
    ds, batch, n = _datasets(data, clip)
    ref = make_loader(ds, batch_size=batch, num_workers=3, clip_mode=clip, seed=9)
    got = make_process_loader(ds, batch_size=batch, num_workers=workers, clip_mode=clip, seed=9)
    try:
        assert len(got.worker_pids) == workers
        for _ in range(n):
            a, b = next(ref), next(got)
            assert all(isinstance(t, torch.Tensor) for t in b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        if clip:
            assert b[0].shape == (2, batch, SIZE, SIZE, 3)  # (T, B, H, W, C)
    finally:
        ref.close()
        _close(got)


def test_rank_shards_concatenate_to_the_global_batch(data):
    ds, _, _ = _datasets(data, clip=False)
    whole = make_process_loader(ds, batch_size=4, num_workers=0, seed=5)
    ranks = [make_process_loader(ds, batch_size=4, num_workers=0, seed=5, rank=r, world=2)
             for r in range(2)]
    for _ in range(3):  # 12 samples of 5: past two epoch boundaries
        want = next(whole)
        parts = [next(r) for r in ranks]
        assert parts[0][0].shape[0] == 2
        for i, leaf in enumerate(want):
            assert torch.equal(torch.cat([p[i] for p in parts]), leaf)
    with pytest.raises(ValueError):
        make_process_loader(ds, batch_size=3, num_workers=0, world=2)
    with pytest.raises(ValueError):
        make_process_loader(ds, batch_size=4, num_workers=0, rank=2, world=2)


@pytest.mark.parametrize("clip", [False, True], ids=["frames", "clips"])
def test_batch_contract_equals_grain(data, clip):
    """Leaves, dtypes and shapes as make_grain_loader gives them (grain draws
    its own per-record generators, so the values differ), run in process as
    tests/test_eval_and_data.py runs it."""
    jds, batch, _ = _datasets(data, clip, jvoc, jvid, jaug)
    tds, _, _ = _datasets(data, clip)
    want = next(make_grain_loader(jds, batch_size=batch, num_workers=0, clip_mode=clip, seed=0,
                                  shard_by_process=False))
    loader = make_process_loader(tds, batch_size=batch, num_workers=0, clip_mode=clip, seed=0)
    got = next(loader)
    loader.close()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape


def test_worker_exception_reraised_and_workers_gone(data, tmp_path):
    """A missing image raises FileNotFoundError in a worker; the consumer
    sees it, and close() leaves no worker alive."""
    import shutil

    root = str(tmp_path / "voc")
    shutil.copytree(data["voc"], root)
    os.remove(os.path.join(root, "VOC2007", "JPEGImages", "000002.jpg"))
    ds = tvoc.VOCDetection(root, image_sets=(("2007", "trainval"),),
                           transform=taug.SSDAugmentation(SIZE, seed=4), seed=1)
    loader = make_process_loader(ds, batch_size=5, num_workers=2, seed=0)
    pids = loader.worker_pids
    assert len(pids) == 2
    with pytest.raises(FileNotFoundError, match="000002"):
        next(loader)  # every batch holds all 5 images
    _close(loader)
    assert not any(p.pid in pids for p in multiprocessing.active_children())
