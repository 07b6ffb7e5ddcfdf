"""The port's data tooling (heat_tpu_torch.utils.data, utils.vision_transforms)
against the JAX package's in a world of one: DataLoader batches bitwise for
the same seed, the shuffles, the prefetcher on the CPU, PartialH5Dataset
through h5py, matrixgallery's invariants, the transforms, the TFRecord tools
on the same bytes and the MNISTDataset fallback."""

import os
import struct

import numpy as np
import pytest
import torch

import heat_tpu as hj
import heat_tpu_torch as ht
from heat_tpu_torch.utils.data import prefetch


@pytest.fixture(autouse=True)
def _on_the_cpu():
    ht.use_device("cpu")


def _data(n=37):
    rng = np.random.default_rng(0)
    return rng.standard_normal((n, 3, 4)).astype(np.float32), np.arange(n, dtype=np.int32)


def _as_numpy(item):
    if isinstance(item, tuple):
        return tuple(_as_numpy(i) for i in item)
    if isinstance(item, ht.DNDarray):
        return item.numpy()
    if isinstance(item, torch.Tensor):
        return item.numpy()
    return np.asarray(item)


@pytest.mark.parametrize("shuffle,drop_last,split", [(True, False, 0), (True, True, None), (False, False, 0),
                                                     (False, True, 0)])
def test_dataloader_batches_are_the_references(shuffle, drop_last, split):
    x, y = _data()
    for seed in (3, 11):
        ht.random.seed(seed)
        hj.random.seed(seed)
        pl = ht.utils.data.DataLoader(ht.utils.data.Dataset([ht.array(x, split=split), ht.array(y, split=split)]),
                                      batch_size=8, shuffle=shuffle, drop_last=drop_last)
        rl = hj.utils.data.DataLoader(hj.utils.data.Dataset([hj.array(x, split=split), hj.array(y, split=split)]),
                                      batch_size=8, shuffle=shuffle, drop_last=drop_last)
        assert len(pl) == len(rl)
        for epoch in range(2):
            got, want = list(pl), list(rl)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for gi, wi in zip(_as_numpy(g), _as_numpy(w)):
                    assert gi.tobytes() == wi.tobytes() and gi.shape == wi.shape


def test_dataloader_of_an_array_and_transforms():
    x, _ = _data()
    ht.random.seed(1)
    hj.random.seed(1)
    norm_p = ht.utils.vision_transforms.Normalize((0.5,), (2.0,))
    norm_r = hj.utils.vision_transforms.Normalize((0.5,), (2.0,))
    pl = ht.utils.data.DataLoader(ht.utils.data.Dataset(ht.array(x, split=0), transforms=[norm_p]), batch_size=5)
    rl = hj.utils.data.DataLoader(hj.utils.data.Dataset(hj.array(x, split=0), transforms=[norm_r]), batch_size=5)
    for g, w in zip(pl, rl):
        assert _as_numpy(g).tobytes() == _as_numpy(w).tobytes()
    assert len(ht.utils.data.DataLoader(ht.array(x), batch_size=5)) == 8


def test_shuffles_are_the_references():
    x, y = _data()
    for fn in ("dataset_shuffle", "dataset_ishuffle"):
        ht.random.seed(7)
        hj.random.seed(7)
        pd = ht.utils.data.Dataset([ht.array(x, split=0), ht.array(y, split=0)])
        rd = hj.utils.data.Dataset([hj.array(x, split=0), hj.array(y, split=0)])
        getattr(ht.utils.data, fn)(pd)
        getattr(hj.utils.data, fn)(rd)
        if fn == "dataset_ishuffle":
            ht.utils.data.dataset_irecv(pd)
            hj.utils.data.dataset_irecv(rd)
        for a, b in zip(pd.arrays, rd.arrays):
            assert a.numpy().tobytes() == b.numpy().tobytes() and a.split == 0
        assert sorted(pd.arrays[1].numpy().tolist()) == list(range(len(y)))
        np.testing.assert_array_equal(pd.arrays[0].numpy(), x[pd.arrays[1].numpy()])
    ht.utils.data.dataset_irecv(pd)  # nothing pending: a no-op
    # the ishuffle cycle of a loader: each epoch completes the last shuffle and starts the next
    ht.random.seed(2)
    hj.random.seed(2)
    pl = ht.utils.data.DataLoader(ht.utils.data.Dataset(ht.array(y, split=0), ishuffle=True), batch_size=10)
    rl = hj.utils.data.DataLoader(hj.utils.data.Dataset(hj.array(y, split=0), ishuffle=True), batch_size=10)
    for _ in range(2):
        for g, w in zip(pl, rl):
            assert _as_numpy(g).tobytes() == _as_numpy(w).tobytes()


def test_prefetch_on_the_cpu_keeps_order_and_counts():
    prefetch.prefetch_stats(reset=True)
    batches = [(np.full((4, 2), i, np.float32), torch.arange(i, i + 4), {"k": ht.array(np.arange(3) + i)}, "tag")
               for i in range(6)]
    got = list(ht.utils.data.prefetch_to_device(iter(batches), size=2))
    assert len(got) == 6
    for i, (a, b, d, s) in enumerate(got):
        assert isinstance(a, torch.Tensor) and a.numpy().tolist() == batches[i][0].tolist()
        assert b.tolist() == list(range(i, i + 4)) and d["k"].numpy().tolist() == [i, i + 1, i + 2] and s == "tag"
    assert prefetch.prefetch_stats() == {"prefetch_hits": 6, "prefetch_misses": 0}
    with pytest.raises(ValueError):
        ht.utils.data.prefetch_to_device(iter(batches), size=0)
    # close() releases an unbounded source without draining it
    closed = []

    def stream():
        try:
            i = 0
            while True:
                yield np.array([i])
                i += 1
        finally:
            closed.append(True)

    with ht.utils.data.prefetch_to_device(stream(), size=3) as it:
        assert [int(next(it)[0]) for _ in range(4)] == [0, 1, 2, 3]
    assert closed == [True]
    assert list(it) == []
    # the rows of this rank, as the reference's split sharding
    assert ht.utils.data.sharding_for_batch(8) == (0, 8)
    assert ht.utils.data.sharding_for_batch(6, comm=ht.parallel.Communication(size=4, rank=1)) is None
    assert ht.utils.data.sharding_for_batch(8, comm=ht.parallel.Communication(size=4, rank=1)) == (2, 4)
    x, _ = _data()
    pl = ht.utils.data.DataLoader(ht.array(x, split=0), batch_size=8, shuffle=False, prefetch=2)
    assert [b.numpy().tobytes() for b in pl] == [x[i:i + 8].tobytes() for i in range(0, 37, 8)]
    pl.close()
    pl.close()


def test_partial_h5_dataset_streams_windows_in_order(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(5)
    data, labels = rng.standard_normal((53, 4)).astype(np.float32), np.arange(53, dtype=np.int64)
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data)
        f.create_dataset("labels", data=labels)
    prefetch.prefetch_stats(reset=True)
    ds = ht.utils.data.PartialH5Dataset(path, dataset_names=["data", "labels"], load_length=10)
    rds = hj.utils.data.PartialH5Dataset(path, dataset_names=["data", "labels"], load_length=10)
    assert len(ds) == len(rds) == 53
    got, want = list(ds), list(rds)
    assert len(got) == len(want) == 6
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.numpy().tobytes() == np.asarray(wx).tobytes() and gy.numpy().tobytes() == np.asarray(wy).tobytes()
    np.testing.assert_array_equal(np.concatenate([g[0].numpy() for g in got]), data)
    stats = prefetch.prefetch_stats()
    assert stats["prefetch_hits"] + stats["prefetch_misses"] == 6

    class InMemory(ht.utils.data.PartialH5Dataset):
        def __init__(self, arr, load_length):
            self.arr, self.length, self.load_length = arr, arr.shape[0], load_length
            self.transforms, self.dataset_names, self.comm = None, ["data"], None

        def read_window(self, start, stop):
            return [self.arr[start:stop]]

    windows = list(InMemory(data, 7))
    np.testing.assert_array_equal(np.concatenate([w.numpy() for w in windows]), data)
    it = iter(InMemory(data, 7))
    next(it)
    it.close()
    it.close()


def test_matrixgallery_invariants():
    g = ht.utils.data.matrixgallery
    q = g.random_orthogonal(12, 4)
    np.testing.assert_allclose(q.numpy().T @ q.numpy(), np.eye(4), atol=1e-5)
    A, (U, S, V) = g.random_known_singularvalues(10, 8, [3.0, 2.0, 1.0])
    np.testing.assert_allclose(np.linalg.svd(A.numpy(), compute_uv=False)[:3], [3.0, 2.0, 1.0], rtol=1e-4)
    A2, _ = g.random_known_rank(10, 8, 3)
    assert np.linalg.matrix_rank(A2.numpy(), tol=1e-4) == 3
    p = g.parter(5, split=0)
    np.testing.assert_array_equal(p.numpy(), hj.utils.data.matrixgallery.parter(5).numpy())
    h = g.hermitian(6, dtype=ht.float32, positive_definite=True)
    assert np.linalg.eigvalsh(h.numpy()).min() > 0
    hc = g.hermitian(5).numpy()
    np.testing.assert_allclose(hc, hc.conj().T, atol=0)
    with pytest.raises(ValueError):
        g.random_orthogonal(3, 4)
    # the same draws as the reference's
    ht.random.seed(4)
    hj.random.seed(4)
    np.testing.assert_allclose(g.hermitian(7).numpy(), hj.utils.data.matrixgallery.hermitian(7).numpy(), atol=1e-6)


def test_transforms_are_the_references_bitwise():
    vt_p, vt_r = ht.utils.vision_transforms, hj.utils.vision_transforms
    rng = np.random.default_rng(9)
    hwc = rng.integers(0, 256, (10, 12, 3)).astype(np.uint8)
    chw = rng.standard_normal((3, 10, 12)).astype(np.float32)
    gray = rng.integers(0, 256, (10, 12)).astype(np.uint8)
    cases = [
        (vt_p.ToTensor(), vt_r.ToTensor(), hwc), (vt_p.ToTensor(), vt_r.ToTensor(), gray),
        (vt_p.Normalize((0.1, 0.2, 0.3), (1.5, 2.0, 0.5)), vt_r.Normalize((0.1, 0.2, 0.3), (1.5, 2.0, 0.5)), chw),
        (vt_p.CenterCrop(6), vt_r.CenterCrop(6), chw), (vt_p.CenterCrop((4, 20)), vt_r.CenterCrop((4, 20)), chw),
        (vt_p.Lambda(lambda t: t * 2), vt_r.Lambda(lambda t: t * 2), chw),
        (vt_p.Compose([vt_p.ToTensor(), vt_p.Normalize((0.5,), (0.25,)), vt_p.CenterCrop(8)]),
         vt_r.Compose([vt_r.ToTensor(), vt_r.Normalize((0.5,), (0.25,)), vt_r.CenterCrop(8)]), hwc),
    ]
    for p, r, img in cases:
        assert _as_numpy(p(img)).tobytes() == np.asarray(r(img)).tobytes(), repr(p)
        assert repr(p) == repr(r)
    for img in (hwc, chw, gray):
        p, r = vt_p.RandomHorizontalFlip(0.5, np.random.default_rng(3)), vt_r.RandomHorizontalFlip(0.5, np.random.default_rng(3))
        for _ in range(6):
            assert _as_numpy(p(img)).tobytes() == np.asarray(r(img)).tobytes()
    # on a batch split along its rows: each rank's rows, the split kept
    batch = rng.standard_normal((9, 3, 8, 8)).astype(np.float32)
    for p, r in ((vt_p.Normalize((0.5,), (2.0,)), vt_r.Normalize((0.5,), (2.0,))), (vt_p.CenterCrop(4), vt_r.CenterCrop(4))):
        got = p(ht.array(batch, split=0))
        assert isinstance(got, ht.DNDarray) and got.split == 0
        assert got.numpy().tobytes() == np.asarray(r(hj.array(batch, split=0))).tobytes()
    with pytest.raises(AttributeError):
        vt_p.NoSuchTransform


def _tfrecord(path, payloads):
    with open(path, "wb") as f:
        for p in payloads:
            f.write(struct.pack("<Q", len(p)) + b"\0" * 4 + p + b"\0" * 4)


def test_tfrecord_tools_on_the_same_bytes(tmp_path):
    h5py = pytest.importorskip("h5py")
    for d in ("train", "val", "train_idx_p", "val_idx_p", "train_idx_r", "val_idx_r", "out_p", "out_r"):
        os.makedirs(tmp_path / d)
    _tfrecord(tmp_path / "train" / "train-0", [b"abc", b"", b"hello world"])
    _tfrecord(tmp_path / "train" / "train-1", [b"x" * 70])
    _tfrecord(tmp_path / "val" / "val-0", [b"12345"])
    from heat_tpu.utils.data import _utils as ref_utils
    from heat_tpu_torch.utils.data import _utils as port_utils

    path = str(tmp_path / "train" / "train-0")
    assert port_utils.tfrecord_index(path) == ref_utils.tfrecord_index(path) == [(0, 19), (19, 16), (35, 27)]
    port_utils.dali_tfrecord2idx(tmp_path / "train", tmp_path / "train_idx_p", tmp_path / "val", tmp_path / "val_idx_p")
    ref_utils.dali_tfrecord2idx(tmp_path / "train", tmp_path / "train_idx_r", tmp_path / "val", tmp_path / "val_idx_r")
    for split in ("train", "val"):
        for name in os.listdir(tmp_path / f"{split}_idx_r"):
            assert (tmp_path / f"{split}_idx_p" / name).read_bytes() == (tmp_path / f"{split}_idx_r" / name).read_bytes()
    merged = tmp_path / "merged"
    os.makedirs(merged)
    for src in ("train", "val"):
        for name in os.listdir(tmp_path / src):
            (merged / name).write_bytes((tmp_path / src / name).read_bytes())
    port_utils.merge_files_imagenet_tfrecord(str(merged), str(tmp_path / "out_p"))
    ref_utils.merge_files_imagenet_tfrecord(str(merged), str(tmp_path / "out_r"))
    for name in ("imagenet_merged.h5", "imagenet_merged_validation.h5"):
        with h5py.File(tmp_path / "out_p" / name) as a, h5py.File(tmp_path / "out_r" / name) as b:
            for key in ("records", "index"):
                np.testing.assert_array_equal(a[key][()], b[key][()])
    bad = tmp_path / "bad"
    bad.write_bytes(struct.pack("<Q", 100) + b"short")
    with pytest.raises(ValueError):
        port_utils.tfrecord_index(str(bad))


def test_mnist_dataset_fallback():
    ds = ht.utils.data.MNISTDataset("unused", train=True)
    ref = hj.utils.data.MNISTDataset("unused", train=True)
    assert len(ds) == len(ref) == 1024
    assert ds.images.numpy().tobytes() == ref.images.numpy().tobytes()
    assert ds.labels.numpy().tobytes() == ref.labels.numpy().tobytes()
    assert ds.train and ds.images.split == 0
    norm = ht.utils.vision_transforms.Normalize((0.0,), (2.0,))
    item = ht.utils.data.MNISTDataset("unused", transform=norm)[torch.arange(4)]
    np.testing.assert_array_equal(item[0].numpy(), ref.images.numpy()[:4] / 2.0)
