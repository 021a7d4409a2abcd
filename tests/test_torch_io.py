"""The port's DataLoader, datasets, samplers and shared-memory ring
(paddle_tpu_torch/io), on the CPU.

`TestAgainstJax` holds the port against the JAX package's paddle_tpu.io
and FakeData on the same inputs: dataset items, the DataLoader's
unshuffled batches in-process and in 2 workers (values, dtypes and the
last partial batch) equal; BatchSampler's and DistributedBatchSampler's
index lists equal; the card run's transform pipeline, run in the port's
workers, within one uint8 level (1/127.5 after Normalize) of the JAX
transforms under the same per-worker seeds (the Resize inside
RandomResizedCrop is antialiased `F.interpolate` against
`jax.image.resize`: tests/test_torch_vision.py measures that gap).

The other classes are twins of tests/test_io_vision.py's dataset,
DataLoader and transform tests (:16-110) and of tests/test_shm_ring.py:
the same checks against the port's modules, whose native ring is the
port's own copy of shm_ring.cc built into build/paddle_tpu_torch/.
RandomSampler and random_split draw from the port's generator, not
jax.random, so their orders are held as permutations, and the same seed
repeats them.
"""
import multiprocessing as mp
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)       # the test workers share the cores

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.io import (DataLoader, TensorDataset,  # noqa: E402
                                 DistributedBatchSampler, Subset,
                                 ConcatDataset, random_split,
                                 IterableDataset, RandomSampler)
from paddle_tpu_torch.io import shm_ring  # noqa: E402
from paddle_tpu_torch.io.shm_ring import ShmRing, decode, encode  # noqa: E402,E501
from paddle_tpu_torch.vision import FakeData  # noqa: E402
from paddle_tpu_torch.vision import transforms as T  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._current_place
    paddle.set_device("cpu")
    yield
    tdevice._current_place = prev


@pytest.fixture
def native():
    if not shm_ring.native_available():
        pytest.skip(f"native shm_ring unavailable: {shm_ring._lib_error!r}")


class TestDatasets:
    def test_tensor_dataset(self):
        ds = TensorDataset([paddle.to_tensor(np.random.randn(10, 3)),
                            paddle.arange(10)])
        assert len(ds) == 10
        x, y = ds[3]
        assert x.shape == [3] and int(y.numpy()) == 3

    def test_concat_subset_split(self):
        a = FakeData(size=6, image_shape=(2,), num_classes=2)
        b = FakeData(size=4, image_shape=(2,), num_classes=2)
        cat = ConcatDataset([a, b])
        assert len(cat) == 10
        sub = Subset(a, [0, 2])
        assert len(sub) == 2
        tr, va = random_split(a, [4, 2])
        assert len(tr) == 4 and len(va) == 2
        assert sorted(tr.indices + va.indices) == list(range(6))
        tr, va = random_split(a, [0.5, 0.5])
        assert len(tr) + len(va) == 6

    def test_random_sampler_is_a_seeded_permutation(self):
        ds = FakeData(size=50, image_shape=(2,))
        paddle.seed(3)
        first = list(RandomSampler(ds))
        assert sorted(first) == list(range(50)) and first != list(range(50))
        paddle.seed(3)
        assert list(RandomSampler(ds)) == first
        draws = list(RandomSampler(ds, replacement=True, num_samples=20))
        assert len(draws) == 20 and all(0 <= i < 50 for i in draws)


class TestDataLoader:
    def test_basic_batching(self):
        ds = FakeData(size=10, image_shape=(3, 4, 4), num_classes=3)
        dl = DataLoader(ds, batch_size=4)
        batches = list(dl)
        assert len(batches) == 3
        x, y = batches[0]
        assert x.shape == [4, 3, 4, 4] and x.dtype == torch.float32
        assert y.shape == [4] and y.dtype == torch.int64
        assert batches[-1][0].shape[0] == 2  # remainder kept

    def test_drop_last_shuffle(self):
        ds = FakeData(size=10, image_shape=(2,), num_classes=2)
        dl = DataLoader(ds, batch_size=4, drop_last=True, shuffle=True)
        assert len(list(dl)) == 2

    def test_iterable_dataset(self):
        class Stream(IterableDataset):
            def __iter__(self):
                for i in range(7):
                    yield np.float32(i)

        dl = DataLoader(Stream(), batch_size=3)
        batches = list(dl)
        assert len(batches) == 3
        np.testing.assert_allclose(batches[0].numpy(), [0, 1, 2])

    def test_multiprocess_workers(self):
        ds = FakeData(size=12, image_shape=(2, 3), num_classes=2)
        dl = DataLoader(ds, batch_size=4, num_workers=2)
        ref = DataLoader(ds, batch_size=4, num_workers=0,
                         use_buffer_reader=False)
        got = [b[0].numpy() for b in dl]
        want = [b[0].numpy() for b in ref]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w)

    def test_worker_error_propagates(self):
        class Bad(FakeData):
            def __getitem__(self, idx):
                raise ValueError("boom")

        dl = DataLoader(Bad(size=4, image_shape=(2,)), batch_size=2,
                        num_workers=1)
        with pytest.raises(ValueError):
            list(dl)

    def test_distributed_batch_sampler_shards(self):
        ds = FakeData(size=12, image_shape=(2,), num_classes=2)
        seen = []
        for rank in range(3):
            bs = DistributedBatchSampler(ds, batch_size=2, num_replicas=3,
                                         rank=rank)
            idx = [i for batch in bs for i in batch]
            assert len(idx) == 4
            seen.extend(idx)
        assert sorted(seen) == list(range(12))
        # without a torch.distributed group: one replica of rank 0
        solo = DistributedBatchSampler(ds, batch_size=4)
        assert (solo.nranks, solo.local_rank) == (1, 0)

    def test_workers_run_transforms(self):
        """The card run's pipeline at a tiny size: uint8 HWC images through
        the random crop, flip, Normalize and Transpose in 2 workers."""
        imgs = np.random.default_rng(0).integers(
            0, 256, (6, 20, 24, 3), dtype=np.uint8)
        tf = T.Compose([T.RandomResizedCrop(16), T.RandomHorizontalFlip(),
                        T.Normalize([127.5] * 3, [127.5] * 3, "HWC"),
                        T.Transpose()])

        class Images(paddle.io.Dataset):
            def __len__(self):
                return len(imgs)

            def __getitem__(self, i):
                return tf(imgs[i]), np.int64(i)

        dl = DataLoader(Images(), batch_size=3, shuffle=True, num_workers=2,
                        use_shared_memory=True)
        xs, ys = zip(*[(x.numpy(), y.numpy()) for x, y in dl])
        assert all(x.shape == (3, 3, 16, 16) and x.dtype == np.float32
                   for x in xs)
        assert sorted(np.concatenate(ys).tolist()) == list(range(6))
        assert all(np.abs(x).max() <= 1.0 + 1e-6 for x in xs)


class TestTransforms:
    def test_compose_pipeline(self):
        img = (np.random.default_rng(0).uniform(0, 255, (32, 40, 3))).astype(
            np.uint8)
        tf = T.Compose([T.Resize(36), T.CenterCrop(32), T.ToTensor(),
                        T.Normalize([0.5, 0.5, 0.5], [0.5, 0.5, 0.5])])
        out = tf(img)
        assert out.shape == (3, 32, 32)
        assert out.dtype == np.float32
        assert -1.01 <= out.min() and out.max() <= 1.01

    def test_flip_crop(self):
        img = np.arange(24, dtype=np.uint8).reshape(4, 6)
        assert T.RandomHorizontalFlip(1.0)(img)[0, 0] == img[0, -1]
        out = T.RandomCrop(2)(img)
        assert out.shape == (2, 2)


class TestCodec:
    def round_trip(self, obj):
        buf = bytearray()
        encode(obj, buf)
        return decode(buf)

    def test_scalars_and_strings(self):
        for obj in [1, -7, 3.5, True, False, None, "héllo", b"\x00\xff"]:
            assert self.round_trip(obj) == obj

    def test_arrays(self):
        for dt in ["float32", "int64", "uint8", "bool", "float16"]:
            a = (np.arange(24).reshape(2, 3, 4) % 2).astype(dt)
            out = self.round_trip(a)
            assert out.dtype == a.dtype and out.shape == a.shape
            np.testing.assert_array_equal(out, a)

    def test_nested_tree(self):
        obj = {"x": [np.ones((4, 5), np.float32), 3],
               "y": (None, {"z": np.arange(6)}), "s": "label"}
        out = self.round_trip(obj)
        np.testing.assert_array_equal(out["x"][0], obj["x"][0])
        assert out["x"][1] == 3 and out["y"][0] is None
        np.testing.assert_array_equal(out["y"][1]["z"], obj["y"][1]["z"])
        assert out["s"] == "label"

    def test_numpy_scalar_types_preserved(self):
        # must match the queue transport: np scalars keep their exact type
        for s in [np.float32(1.5), np.float16(2.0), np.int32(7),
                  np.uint8(255), np.bool_(True)]:
            out = self.round_trip(s)
            assert type(out) is type(s) and out == s

    def test_pickle_fallback(self):
        err = ValueError("boom")
        out = self.round_trip((1, None, err))
        assert isinstance(out[2], ValueError) and out[2].args == ("boom",)

    def test_object_and_structured_dtypes(self):
        # raw transport can't carry these; codec must pickle-fallback
        a = np.empty(3, dtype=object)
        a[:] = [(1, 2), "x", None]
        out = self.round_trip(a)
        assert out.dtype == object and list(out) == [(1, 2), "x", None]
        s = np.array([(1.5, 2)], dtype=[("x", "f4"), ("y", "i8")])
        out = self.round_trip(s)
        assert out.dtype.fields is not None
        assert out["x"][0] == np.float32(1.5) and out["y"][0] == 2

    def test_array_alignment(self):
        # decode must produce aligned views regardless of header sizes
        a = np.arange(7, dtype=np.float64)
        obj = {"pad": "x" * 3, "a": a}
        out = self.round_trip(obj)
        np.testing.assert_array_equal(out["a"], a)


def _producer(name, start, count):
    ring = ShmRing.attach(name)
    for i in range(start, start + count):
        ring.send(i, {"i": i, "data": np.full((32,), i, np.int32)})
    ring.close()


@pytest.mark.usefixtures("native")
class TestRing:
    def test_inprocess_round_trip(self):
        ring = ShmRing(slot_bytes=4096, n_slots=4)
        ring.send(7, [np.arange(10), "ok"])
        msg_id, obj = ring.recv(timeout_ms=2000)
        assert msg_id == 7
        np.testing.assert_array_equal(obj[0], np.arange(10))
        assert obj[1] == "ok"
        ring.close(unlink=True)

    def test_chunking_large_message(self):
        ring = ShmRing(slot_bytes=1024, n_slots=4)
        big = np.random.default_rng(0).integers(0, 255, 10_000).astype(np.uint8)
        import threading
        t = threading.Thread(target=ring.send, args=(1, big))
        t.start()
        msg_id, out = ring.recv(timeout_ms=5000)
        t.join()
        assert msg_id == 1
        np.testing.assert_array_equal(out, big)
        ring.close(unlink=True)

    def test_multiprocess_producers(self):
        ring = ShmRing(slot_bytes=8192, n_slots=8)
        ctx = mp.get_context("fork")
        procs = [ctx.Process(target=_producer, args=(ring.name, w * 100, 5))
                 for w in range(3)]
        for p in procs:
            p.start()
        got = {}
        for _ in range(15):
            msg_id, obj = ring.recv(timeout_ms=10000)
            got[msg_id] = obj
        for p in procs:
            p.join(timeout=5)
        assert set(got) == {w * 100 + i for w in range(3) for i in range(5)}
        for msg_id, obj in got.items():
            assert obj["i"] == msg_id
            np.testing.assert_array_equal(
                obj["data"], np.full((32,), msg_id, np.int32))
        ring.close(unlink=True)

    def test_recv_timeout(self):
        ring = ShmRing(slot_bytes=1024, n_slots=2)
        assert ring.recv(timeout_ms=50) is None
        ring.close(unlink=True)

    def test_stop_unblocks_producer(self):
        ring = ShmRing(slot_bytes=1024, n_slots=2)
        # fill all slots so the next acquire would block
        ring.send_bytes(0, b"x" * 100)
        ring.send_bytes(1, b"y" * 100)
        import threading
        errs = []

        def blocked():
            try:
                ring.send_bytes(2, b"z" * 100)
            except RuntimeError as e:
                errs.append(e)

        t = threading.Thread(target=blocked)
        t.start()
        import time
        time.sleep(0.1)
        ring.stop()
        t.join(timeout=5)
        assert not t.is_alive() and errs
        ring.close(unlink=True)


@pytest.mark.usefixtures("native")
class TestDataLoaderShm:
    def _loader(self, **kw):
        from paddle_tpu_torch.io import DataLoader, Dataset

        class DS(Dataset):
            def __len__(self):
                return 16

            def __getitem__(self, i):
                return np.full((8,), i, np.float32), i

        return DataLoader(DS(), batch_size=4, num_workers=2,
                          use_shared_memory=True, **kw)

    def test_shm_transport_in_order(self):
        loader = self._loader()
        it = iter(loader)
        assert it.ring is not None  # shm path actually active
        batches = list(it)
        assert len(batches) == 4
        for b, (xs, ys) in enumerate(batches):
            np.testing.assert_array_equal(
                ys.numpy(), np.arange(4 * b, 4 * b + 4))
            np.testing.assert_allclose(
                xs.numpy()[:, 0], np.arange(4 * b, 4 * b + 4))

    def test_worker_error_via_ring(self):
        from paddle_tpu_torch.io import DataLoader, Dataset

        class Bad(Dataset):
            def __len__(self):
                return 8

            def __getitem__(self, i):
                if i == 5:
                    raise ValueError("bad sample")
                return np.zeros(2, np.float32)

        loader = DataLoader(Bad(), batch_size=2, num_workers=2,
                            use_shared_memory=True)
        with pytest.raises(ValueError, match="bad sample"):
            list(loader)

    def test_unpicklable_worker_error_does_not_hang(self):
        from paddle_tpu_torch.io import DataLoader, Dataset

        class Evil(Exception):
            def __reduce__(self):
                raise TypeError("cannot pickle me")

        class Bad(Dataset):
            def __len__(self):
                return 4

            def __getitem__(self, i):
                if i == 2:
                    raise Evil("boom")
                return np.zeros(2, np.float32)

        loader = DataLoader(Bad(), batch_size=2, num_workers=2,
                            use_shared_memory=True)
        with pytest.raises(RuntimeError, match="Evil"):
            list(loader)


# ------------------------------------------------- against the JAX package
import paddle_tpu as jp  # noqa: E402
from paddle_tpu import io as jio  # noqa: E402
from paddle_tpu.vision import FakeData as JFakeData  # noqa: E402
from paddle_tpu.vision import transforms as JT  # noqa: E402

# the worker pipeline's tolerance: one uint8 level of the resized crop,
# after Normalize's division by 127.5
LEVEL_TOL = 1 / 127.5 + 1e-6
WORKER_SEED = 1234


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _seed_worker(worker_id):
    random.seed(WORKER_SEED + worker_id)


def _pipeline(T_):
    return T_.Compose([T_.RandomResizedCrop(16), T_.RandomHorizontalFlip(),
                       T_.Normalize([127.5] * 3, [127.5] * 3, "HWC"),
                       T_.Transpose()])


class TestAgainstJax:
    @pytest.mark.parametrize("transform", [None, "normalize"])
    def test_fake_data_items_equal(self, transform):
        """Both packages' FakeData give the same images and labels."""
        kw = dict(size=8, image_shape=(3, 6, 5), num_classes=7, seed=5)
        if transform:
            kw["transform"] = lambda a: (a - 0.5) / 2.0
        j, t = JFakeData(**kw), FakeData(**kw)
        assert len(j) == len(t) == 8
        for i in range(8):
            (jx, jy), (tx, ty) = j[i], t[i]
            assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)

    def test_tensor_concat_subset_items_equal(self):
        rng = np.random.default_rng(0)
        xs = rng.standard_normal((6, 3)).astype(np.float32)
        ys = np.arange(6, dtype=np.int64)
        a = (jio.TensorDataset([jp.to_tensor(xs), jp.to_tensor(ys)]),
             TensorDataset([paddle.to_tensor(xs), paddle.to_tensor(ys)]))
        f = (JFakeData(size=4, image_shape=(3,), num_classes=5),
             FakeData(size=4, image_shape=(3,), num_classes=5))
        pairs = [a, (jio.ConcatDataset([a[0], f[0]]),
                     ConcatDataset([a[1], f[1]])),
                 (jio.Subset(f[0], [3, 1]), Subset(f[1], [3, 1]))]
        for j, t in pairs:
            assert len(j) == len(t)
            for i in range(len(j)):
                for jv, tv in zip(j[i], t[i]):
                    np.testing.assert_array_equal(_np(tv), _np(jv))

    @pytest.mark.parametrize("num_workers", [0, 2])
    @pytest.mark.parametrize("drop_last", [False, True])
    def test_loader_batches_equal(self, num_workers, drop_last):
        """Unshuffled batches: the same values and dtypes, and the last
        partial batch kept or dropped alike."""
        kw = dict(size=10, image_shape=(3, 4, 4), num_classes=3)
        j = list(jio.DataLoader(JFakeData(**kw), batch_size=4,
                                drop_last=drop_last,
                                num_workers=num_workers))
        t = list(DataLoader(FakeData(**kw), batch_size=4,
                            drop_last=drop_last, num_workers=num_workers))
        assert len(t) == len(j) == (2 if drop_last else 3)
        assert t[-1][0].shape[0] == (4 if drop_last else 2)
        for (jx, jy), (tx, ty) in zip(j, t):
            for jv, tv in ((jx, tx), (jy, ty)):
                jv, tv = _np(jv), _np(tv)
                assert tv.dtype == jv.dtype and tv.shape == jv.shape
                np.testing.assert_array_equal(tv, jv)

    @pytest.mark.parametrize("batch_size,drop_last",
                             [(3, False), (3, True), (4, False), (11, True)])
    def test_batch_sampler_equal(self, batch_size, drop_last):
        ds = FakeData(size=10, image_shape=(1,))
        j = jio.BatchSampler(ds, batch_size=batch_size, drop_last=drop_last)
        t = paddle.io.BatchSampler(ds, batch_size=batch_size,
                                   drop_last=drop_last)
        assert len(t) == len(j)
        assert list(t) == list(j)

    @pytest.mark.parametrize("shuffle", [False, True])
    @pytest.mark.parametrize("drop_last", [False, True])
    def test_distributed_batch_sampler_equal(self, shuffle, drop_last):
        """Every rank's index lists, over two epochs (the shuffle is
        numpy's, seeded by the epoch, in both packages)."""
        ds = FakeData(size=11, image_shape=(1,))
        for rank in range(3):
            kw = dict(batch_size=2, num_replicas=3, rank=rank,
                      shuffle=shuffle, drop_last=drop_last)
            j = jio.DistributedBatchSampler(ds, **kw)
            t = DistributedBatchSampler(ds, **kw)
            for epoch in (0, 1):
                j.set_epoch(epoch)
                t.set_epoch(epoch)
                assert len(t) == len(j)
                assert list(t) == list(j), (rank, epoch)

    def test_worker_transforms_match_jax_seeded_crops(self):
        """The card run's pipeline (crop, flip, Normalize, Transpose) in
        2 of the port's workers, each seeded by worker_init_fn, against
        the JAX transforms run here under the same seeds: worker w takes
        batches w, w + 2, ... in order."""
        imgs = np.random.default_rng(0).integers(
            0, 256, (12, 20, 24, 3), dtype=np.uint8)
        tf = _pipeline(T)

        class Images(paddle.io.Dataset):
            def __len__(self):
                return len(imgs)

            def __getitem__(self, i):
                return tf(imgs[i]), np.int64(i)

        got = [(x.numpy(), y.numpy()) for x, y in DataLoader(
            Images(), batch_size=3, num_workers=2, use_shared_memory=True,
            worker_init_fn=_seed_worker)]
        assert len(got) == 4
        jtf = _pipeline(JT)
        want = {}
        for wid in range(2):
            random.seed(WORKER_SEED + wid)
            for b in range(wid, 4, 2):
                want[b] = np.stack([np.asarray(jtf(imgs[i]))
                                    for i in range(3 * b, 3 * b + 3)])
        for b, (x, y) in enumerate(got):
            np.testing.assert_array_equal(y, np.arange(3 * b, 3 * b + 3))
            assert x.shape == want[b].shape == (3, 3, 16, 16)
            assert x.dtype == want[b].dtype == np.float32
            assert float(np.abs(x - want[b]).max()) <= LEVEL_TOL, b
