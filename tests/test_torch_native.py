"""The port's native runtime (``deeplearning4j_tpu_torch/native/``) against
the JAX package's, on the CPU.

The port builds ``native/dl4jtpu_native.cpp`` with g++ into its own build
directory under a hashed name (never into ``native/build/``, which the
JAX package owns); both packages' iterators over the same files deliver
the same batches bit for bit. ``tests/test_native.py``'s cases run here on
the port, the DataVec CSV reader's fast path among them (the port's
``CSVRecordReader.numeric_array`` through the port's build, held against
the JAX reader's). ``normalize`` and ``device_prefetch`` run on the CPU here
(``device="cpu"``); the pinned side-stream copy runs in the ``cuda`` case.
"""

import os
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.native as jax_native
import deeplearning4j_tpu_torch.native as native
from deeplearning4j_tpu_torch.native import (
    NativeDataSetIterator, NativeImageDataSetIterator, Workspace,
    native_available, native_csv_parse, trim_compile_cache,
    write_binary_dataset, write_image_dataset,
)
from deeplearning4j_tpu_torch.native import lib as native_lib
from deeplearning4j_tpu_torch.nlp.tokenizers import (
    CommonPreprocessor, DefaultTokenizerFactory,
)

FX = Path(__file__).parent / "fixtures"
REPO = Path(__file__).resolve().parent.parent


def test_exports_equal_the_jax_all():
    assert sorted(native.__all__) == sorted(jax_native.__all__)


class TestBuild:
    def test_native_builds(self):
        assert native_available(), "g++ build of native library failed"

    def test_build_lands_in_the_port_build_dir_under_its_hash(self):
        from deeplearning4j_tpu_torch.ops.cuda import build

        path = native_lib.native_library_path()
        assert native_lib.native_built_from_source()
        assert path.parent == build.BUILD_DIR
        assert path in native_lib.built_library_paths()
        assert path.name.startswith("libdl4jtpu-") and path.suffix == ".so"
        # the name follows the source and the flags
        assert path == build.hashed_library_path(
            "libdl4jtpu", [REPO / "native" / "dl4jtpu_native.cpp"],
            native_lib._BASE_FLAGS + native_lib._ATTEMPTS[
                native_lib.built_library_paths().index(path)])
        assert not str(path).startswith(str(REPO / "native"))

    def test_build_publishes_only_a_finished_library(self, tmp_path):
        """The builder writes a temporary file beside the target and moves
        it into place only when the compiler succeeds (``cp`` stands in for
        g++ here, so the session builds the library once)."""
        from deeplearning4j_tpu_torch.ops.cuda.build import compile_library

        src = native_lib.native_library_path()
        target = tmp_path / "lib.so"
        proc, _ = compile_library(lambda out: ["cp", str(src), out], target)
        assert proc.returncode == 0
        assert target.read_bytes() == src.read_bytes()
        failed = tmp_path / "failed.so"
        proc, _ = compile_library(lambda out: ["false"], failed)
        assert proc.returncode != 0
        assert sorted(p.name for p in tmp_path.iterdir()) == ["lib.so"]


class TestNativeTextFront:
    """The Word2Vec text front over the port's build: the counting pass
    against the Python tokenizer, and the pair stream against the JAX
    package's over the same file."""

    def test_word_counts_match_python_tokenizer(self, tmp_path):
        from deeplearning4j_tpu_torch.nlp.native_text import (
            native_word_counts,
        )

        text = ("The CAT sat, on the mat!\nthe dog-ran fast 42 times_x\n"
                "\nMixed CASE punct;;; here\n")
        p = tmp_path / "c.txt"
        p.write_text(text)
        tok = DefaultTokenizerFactory(CommonPreprocessor())
        py = Counter()
        for line in text.splitlines():
            py.update(tok.tokenize(line))
        assert native_word_counts(str(p), n_threads=3) == dict(py)

    def test_stream_equals_the_jax_stream_at_one_thread(self, tmp_path):
        """One worker thread and a fixed seed: the port's stream over its
        own build delivers the JAX package's batches, in order."""
        from deeplearning4j_tpu.nlp.native_text import (
            NativeSkipGramStream as JaxStream,
        )
        from deeplearning4j_tpu_torch.nlp.native_text import (
            NativeSkipGramStream,
        )

        rng = np.random.default_rng(0)
        words = [f"w{i}" for i in range(30)]
        p = tmp_path / "c.txt"
        p.write_text("\n".join(" ".join(rng.choice(words, 9))
                               for _ in range(300)))
        probs = np.ones(30, np.float32) / 30
        keep = np.full(30, 0.9, np.float32)
        kw = dict(window=3, negative=2, batch=16, seed=5, n_threads=1)
        streams = [cls(str(p), words, probs, keep, **kw)
                   for cls in (NativeSkipGramStream, JaxStream)]
        got, want = ([tuple(a.copy() for a in b) for b in s]
                     for s in streams)
        assert len(got) == len(want) > 10
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        assert streams[0].words_seen == streams[1].words_seen
        for s in streams:
            s.close()


class TestWorkspace:
    def test_alloc_reset(self):
        with Workspace(1 << 16) as ws:
            assert ws.native
            a = ws.alloc((64,), np.float32)
            a[:] = 7.0
            b = ws.alloc((32, 8), np.float32)
            b[:] = 1.5
            assert ws.used() >= a.nbytes + b.nbytes
            np.testing.assert_array_equal(a, np.full(64, 7.0, np.float32))
        assert ws.used() == 0
        assert ws.peak() >= 64 * 4

    def test_spill_when_full(self):
        ws = Workspace(256)
        big = ws.alloc((1024,), np.float32)
        big[:] = 3.0
        assert ws.spilled() >= 4096
        assert float(big.sum()) == 3.0 * 1024
        ws.destroy()

    def test_alignment(self):
        ws = Workspace(1 << 12)
        ws.alloc((3,), np.float32)
        b = ws.alloc((4,), np.float32)
        assert b.ctypes.data % 64 == 0
        ws.destroy()

    def test_python_fallback(self, monkeypatch):
        import deeplearning4j_tpu_torch.native.workspace as wsmod

        monkeypatch.setattr(wsmod, "load_native_lib", lambda: None)
        ws = Workspace(256)
        assert not ws.native
        ws.alloc((10,), np.float32)
        assert ws.used() == 40 and ws.spilled() == 0
        ws.reset()
        assert ws.used() == 0


class TestNativePipeline:
    def _make(self, tmp_path, n=64, fd=6, ld=3, batch=16, cls=None, **kw):
        rng = np.random.default_rng(0)
        feats = rng.normal(size=(n, fd)).astype(np.float32)
        labels = np.eye(ld, dtype=np.float32)[rng.integers(0, ld, n)]
        fp, lp = write_binary_dataset(tmp_path, feats, labels)
        it = (cls or NativeDataSetIterator)(fp, lp, n, (fd,), (ld,), batch,
                                            **kw)
        return it, feats, labels

    def test_batches_cover_dataset(self, tmp_path):
        it, feats, _ = self._make(tmp_path, shuffle=True, seed=1)
        assert it.native
        assert it.batches_per_epoch() == 4
        seen = []
        for ds in it:
            assert ds.features.shape == (16, 6)
            assert ds.labels.shape == (16, 3)
            seen.append(ds.features)
        got = np.concatenate(seen)
        np.testing.assert_allclose(np.sort(got.sum(1)), np.sort(feats.sum(1)),
                                   rtol=1e-5)
        it.close()

    def test_batches_equal_the_jax_iterator(self, tmp_path):
        """Same files, seed and threads: both packages' native iterators
        deliver the same batches, in order, over two epochs."""
        mine, _, _ = self._make(tmp_path, shuffle=True, seed=4)
        theirs, _, _ = self._make(tmp_path, shuffle=True, seed=4,
                                  cls=jax_native.NativeDataSetIterator)
        for _ in range(2):
            for a, b in zip(mine, theirs, strict=True):
                np.testing.assert_array_equal(a.features, b.features)
                np.testing.assert_array_equal(a.labels, b.labels)
            mine.reset()
            theirs.reset()

    def test_reset_reshuffles(self, tmp_path):
        it, _, _ = self._make(tmp_path, shuffle=True, seed=2)
        first = np.concatenate([ds.features for ds in it])
        it.reset()
        second = np.concatenate([ds.features for ds in it])
        assert not np.allclose(first, second)
        np.testing.assert_allclose(np.sort(first.sum(1)),
                                   np.sort(second.sum(1)), rtol=1e-5)
        it.close()

    def test_trains_a_model(self, tmp_path):
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            NeuralNetConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
        from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.optimize.updaters import Sgd

        rng = np.random.default_rng(1)
        n = 128
        feats = rng.normal(size=(n, 4)).astype(np.float32)
        w = rng.normal(size=(4, 3)).astype(np.float32)
        labels = np.eye(3, dtype=np.float32)[np.argmax(feats @ w, axis=1)]
        fp, lp = write_binary_dataset(tmp_path, feats, labels)
        it = NativeDataSetIterator(fp, lp, n, (4,), (3,), 32, seed=3)
        conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(lr=0.5))
                .list()
                .layer(DenseLayer(n_out=16, activation="relu"))
                .layer(OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(4)).build())
        model = MultiLayerNetwork(conf).init(device="cpu")
        model.fit(it, epochs=10)
        ev = model.evaluate(it)
        it.reset()
        assert ev.accuracy() > 0.85
        it.close()

    def test_python_fallback_matches(self, tmp_path, monkeypatch):
        it_n, _, _ = self._make(tmp_path, shuffle=False)
        native_rows = np.concatenate([ds.features for ds in it_n])
        it_n.close()
        import deeplearning4j_tpu_torch.native.pipeline as pl

        monkeypatch.setattr(pl, "load_native_lib", lambda: None)
        it_p, _, _ = self._make(tmp_path, shuffle=True, seed=6)
        assert not it_p.native
        monkeypatch.undo()
        import deeplearning4j_tpu.native.pipeline as jpl

        monkeypatch.setattr(jpl, "load_native_lib", lambda: None)
        it_j, _, _ = self._make(tmp_path, shuffle=True, seed=6,
                                cls=jax_native.NativeDataSetIterator)
        # the Python pipeline is the JAX package's, draw for draw
        for a, b in zip(it_p, it_j, strict=True):
            np.testing.assert_array_equal(a.features, b.features)
        monkeypatch.setattr(pl, "load_native_lib", lambda: None)
        it_p, _, _ = self._make(tmp_path, shuffle=False)
        py_rows = np.concatenate([ds.features for ds in it_p])
        np.testing.assert_array_equal(native_rows, py_rows)


class TestNativeCsv:
    def test_csv_matches_python(self, tmp_path, rng):
        data = rng.normal(size=(1000, 7)).astype(np.float32)
        path = tmp_path / "data.csv"
        np.savetxt(path, data, delimiter=",", fmt="%.6f")
        arr = native_csv_parse(path, n_threads=4)
        assert arr is not None and arr.shape == (1000, 7)
        np.testing.assert_allclose(arr, data, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(arr, jax_native.native_csv_parse(
            path, n_threads=4))

    @pytest.mark.parametrize("skip", [0, 1])
    def test_csv_header_and_reader_fastpath(self, tmp_path, rng,
                                            monkeypatch, skip):
        from deeplearning4j_tpu.datavec.records import (
            CSVRecordReader as JaxCSVRecordReader,
        )
        from deeplearning4j_tpu_torch.datavec.records import CSVRecordReader

        assert native_available()
        data = rng.normal(size=(50, 3)).astype(np.float32)
        path = tmp_path / "d.csv"
        with open(path, "w") as f:
            if skip:
                f.write("a,b,c\n")
            for row in data:
                f.write(",".join(f"{v:.6f}" for v in row) + "\n")
        calls = []
        real = native_lib.native_csv_parse
        monkeypatch.setattr(native, "native_csv_parse",
                            lambda *a, **k: calls.append(a) or real(*a, **k))
        arr = CSVRecordReader(path, skip_lines=skip).numeric_array()
        assert len(calls) == 1 and arr.shape == (50, 3)
        np.testing.assert_allclose(arr, data, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(
            arr, JaxCSVRecordReader(path, skip_lines=skip).numeric_array())
        # the Python rows (no native library) agree within the parse
        monkeypatch.setattr(native, "native_csv_parse", lambda *a, **k: None)
        rows = CSVRecordReader(path, skip_lines=skip).numeric_array()
        np.testing.assert_allclose(rows, arr, rtol=0, atol=1e-6)

    def test_csv_parse_thread_split_consistency(self, tmp_path):
        n = 10007
        path = tmp_path / "idx.csv"
        with open(path, "w") as f:
            for i in range(n):
                f.write(f"{i},{i*2},{i*3}\n")
        for t in (1, 3, 8):
            arr = native_csv_parse(path, n_threads=t)
            assert arr.shape == (n, 3), (t, arr.shape)
            np.testing.assert_array_equal(arr[:, 0],
                                          np.arange(n, dtype=np.float32))
            np.testing.assert_array_equal(arr[:, 1],
                                          2 * np.arange(n, dtype=np.float32))

    @pytest.mark.parametrize("name,text,want", [
        ("trailing_delimiter", "1,2,\n4,5,\n", [[1, 2, 0], [4, 5, 0]]),
        ("quoted", '"1","2"\n"3","4"\n', [[1, 2], [3, 4]]),
        ("blank_and_crlf", "\n1,2,3\r\n4,5,6\r\n", [[1, 2, 3], [4, 5, 6]]),
        ("quoted_padded", '" 1.5 ", "2.5"\n"3.5", "4.5"\n',
         [[1.5, 2.5], [3.5, 4.5]]),
    ])
    def test_edge_cases(self, tmp_path, name, text, want):
        path = tmp_path / f"{name}.csv"
        path.write_bytes(text.encode())
        np.testing.assert_allclose(native_csv_parse(path), want)

    @pytest.mark.parametrize("text", ["1.0,2.0,setosa\n3.0,4.0,virginica\n",
                                      "1.0,3.5kg\n2.0,4.0\n"])
    def test_non_numeric_rejected(self, tmp_path, text):
        path = tmp_path / "bad.csv"
        path.write_text(text)
        assert native_csv_parse(path) is None


class TestCacheTrim:
    def test_lru_trim(self, tmp_path):
        d = tmp_path / "cache"
        d.mkdir()
        for i in range(5):
            (d / f"exec_{i}.bin").write_bytes(b"x" * 1000)
            os.utime(d / f"exec_{i}.bin",
                     (time.time() - 1000 + i, time.time() - 1000 + i))
        assert trim_compile_cache(str(d), 2500) == 3000
        assert sorted(p.name for p in d.iterdir()) == ["exec_3.bin",
                                                       "exec_4.bin"]
        assert trim_compile_cache(str(d), 1 << 20) == 0

    def test_default_directory_is_the_port_build_dir(self, monkeypatch,
                                                     tmp_path):
        from deeplearning4j_tpu_torch.ops.cuda import build

        (tmp_path / "old.so").write_bytes(b"x" * 100)
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        assert trim_compile_cache(cap_bytes=0) == 100
        assert list(tmp_path.iterdir()) == []


def _images(tmp_path, rng, n=64, H=12, W=12, C=3, classes=4):
    imgs = rng.integers(0, 256, size=(n, H, W, C)).astype(np.uint8)
    labels = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    f, l = write_image_dataset(tmp_path, imgs, labels)
    return imgs, labels, f, l


class TestNativeImagePipeline:
    def test_center_crop_normalization_exact(self, tmp_path, rng):
        imgs, labels, f, l = _images(tmp_path, rng)
        it = NativeImageDataSetIterator(
            f, l, 64, (12, 12, 3), 4, batch_size=8, crop=(8, 8),
            shuffle=False, augment=False,
            mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25])
        assert it.batches_per_epoch() == 8
        ds = next(iter(it))
        want = (imgs[:8, 2:10, 2:10].astype(np.float32) / 255.0 - 0.5) / 0.25
        np.testing.assert_allclose(np.asarray(ds.features), want, atol=1e-6)
        np.testing.assert_allclose(np.asarray(ds.labels), labels[:8])

    @pytest.mark.parametrize("output", ["f32", "u8"])
    def test_batches_equal_the_jax_iterator(self, tmp_path, rng, output):
        """Same staged files, seed and threads: augmented batches equal
        the JAX package's bit for bit, two epochs."""
        _, _, f, l = _images(tmp_path, rng)
        kw = dict(batch_size=8, crop=(8, 8), augment=True, seed=7,
                  mean=[0.4, 0.5, 0.6], std=[0.2, 0.25, 0.3], output=output)
        mine = NativeImageDataSetIterator(f, l, 64, (12, 12, 3), 4, **kw)
        theirs = jax_native.NativeImageDataSetIterator(f, l, 64, (12, 12, 3),
                                                       4, **kw)
        for _ in range(2):
            for a, b in zip(mine, theirs, strict=True):
                assert a.features.dtype == np.asarray(b.features).dtype
                np.testing.assert_array_equal(a.features,
                                              np.asarray(b.features))
                np.testing.assert_array_equal(a.labels,
                                              np.asarray(b.labels))

    def test_augmentation_varies_per_epoch_reproducible_per_seed(
            self, tmp_path, rng):
        _, _, f, l = _images(tmp_path, rng)

        def epoch_of(it):
            return np.concatenate([np.asarray(b.features) for b in it])

        kw = dict(batch_size=8, crop=(8, 8), augment=True, seed=7)
        it = NativeImageDataSetIterator(f, l, 64, (12, 12, 3), 4, **kw)
        e1, e2 = epoch_of(it), epoch_of(it)
        assert not np.allclose(e1, e2)
        it_b = NativeImageDataSetIterator(f, l, 64, (12, 12, 3), 4, **kw)
        np.testing.assert_allclose(epoch_of(it_b), e1)

    def test_crop_contents_come_from_source_image(self, tmp_path, rng):
        imgs, _, f, l = _images(tmp_path, rng, n=8, H=6, W=6, C=1)
        it = NativeImageDataSetIterator(f, l, 8, (6, 6, 1), 4, batch_size=8,
                                        crop=(4, 4), augment=True, seed=3)
        feats = np.asarray(next(iter(it)).features)
        candidates = []
        for img in imgs.astype(np.float32) / 255.0:
            for top in range(3):
                for left in range(3):
                    crop = img[top:top + 4, left:left + 4]
                    candidates += [crop, crop[:, ::-1]]
        for r in range(8):
            assert any(np.allclose(feats[r], c, atol=1e-6)
                       for c in candidates), f"row {r} is not a valid crop"

    def test_device_prefetch_and_training(self, tmp_path, rng):
        """The pipeline feeds a conv net's fit() with batches staged as
        tensors on the iterator's device."""
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            NeuralNetConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
        from deeplearning4j_tpu_torch.nn.layers import (
            ConvolutionLayer, OutputLayer,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.optimize.updaters import Adam

        _, _, f, l = _images(tmp_path, rng, n=32, H=8, W=8, C=3)
        it = NativeImageDataSetIterator(f, l, 32, (8, 8, 3), 4, batch_size=8,
                                        crop=(8, 8), augment=True,
                                        device_prefetch=True, device="cpu")
        first = next(iter(it))
        assert isinstance(first.features, torch.Tensor)
        assert first.features.device.type == "cpu"
        it.reset()
        conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(lr=1e-2))
                .list()
                .layer(ConvolutionLayer(n_out=4, kernel=(3, 3),
                                        activation="relu"))
                .layer(OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(8, 8, 3)).build())
        model = MultiLayerNetwork(conf).init(device="cpu")
        model.fit(it, epochs=2)
        out = model.output(np.zeros((2, 8, 8, 3), np.float32))
        assert np.isfinite(np.asarray(out)).all()

    def test_device_prefetch_takes_the_card_unless_told(self, tmp_path, rng):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        _, _, f, l = _images(tmp_path, rng, n=8, H=4, W=4, C=3)
        with pytest.raises(RuntimeError, match="cuda"):
            NativeImageDataSetIterator(f, l, 8, (4, 4, 3), 4, batch_size=4,
                                       device_prefetch=True)
        it = NativeImageDataSetIterator(f, l, 8, (4, 4, 3), 4, batch_size=4,
                                        output="u8")
        with pytest.raises(RuntimeError, match="cuda"):
            it.normalize(next(iter(it)).features)

    def test_python_image_pipeline_is_the_jax_one(self, tmp_path, rng,
                                                  monkeypatch):
        """No library: the numpy pipeline draws as the JAX package's."""
        import deeplearning4j_tpu.native.pipeline as jpl
        import deeplearning4j_tpu_torch.native.pipeline as pl

        _, _, f, l = _images(tmp_path, rng, n=16, H=10, W=10, C=3)
        monkeypatch.setattr(pl, "load_native_lib", lambda: None)
        monkeypatch.setattr(jpl, "load_native_lib", lambda: None)
        kw = dict(batch_size=4, crop=(6, 6), augment=True, seed=2,
                  mean=[0.5] * 3, std=[0.2] * 3)
        for output in ("f32", "u8"):
            mine = NativeImageDataSetIterator(f, l, 16, (10, 10, 3), 4,
                                              output=output, **kw)
            theirs = jpl.NativeImageDataSetIterator(f, l, 16, (10, 10, 3),
                                                    4, output=output, **kw)
            assert not mine.native
            for a, b in zip(mine, theirs, strict=True):
                np.testing.assert_array_equal(a.features,
                                              np.asarray(b.features))


class TestImageDecodeFront:
    def _src_image(self):
        y, x = np.mgrid[0:48, 0:64]
        img = np.stack([(x * 4) % 256, (y * 5) % 256,
                        ((x + y) * 3) % 256], -1).astype(np.uint8)
        img[8:20, 8:24] = [255, 0, 0]
        img[28:40, 40:60] = [0, 255, 64]
        return img

    def test_png_decode_lossless(self):
        dec = native.decode_image_file(FX / "golden_image.png", (48, 64, 3))
        np.testing.assert_array_equal(dec, self._src_image())

    def test_jpeg_decode_matches_committed_golden(self):
        golden = np.load(FX / "golden_image_jpg_u8.npy")
        dec = native.decode_image_file(FX / "golden_image.jpg", (48, 64, 3))
        diff = np.abs(dec.astype(int) - golden.astype(int))
        assert diff.max() <= 2, f"jpeg decode drifted: max diff {diff.max()}"

    def test_grayscale_and_probe(self):
        assert native.probe_image(FX / "golden_gray.png") == (32, 32)
        assert native.probe_image(FX / "golden_image.jpg") == (48, 64)
        g = native.decode_image_file(FX / "golden_gray.png", (32, 32, 1))
        y, x = np.mgrid[0:32, 0:32]
        np.testing.assert_array_equal(
            g[..., 0], ((x * 7 + y * 3) % 256).astype(np.uint8))

    def test_resize_matches_committed_golden_and_pil(self):
        from deeplearning4j_tpu_torch.native.pipeline import _pil_decode

        golden = np.load(FX / "golden_image_resized_u8.npy")
        dec = native.decode_image_file(FX / "golden_image.png", (32, 32, 3))
        np.testing.assert_array_equal(dec, golden)
        pil = _pil_decode(FX / "golden_image.png", (32, 32, 3))
        assert np.abs(dec.astype(float) - pil.astype(float)).mean() < 12.0

    def test_decode_failure_raises(self, tmp_path):
        bad = tmp_path / "not_an_image.jpg"
        bad.write_bytes(b"definitely not a jpeg")
        with pytest.raises((ValueError, RuntimeError, OSError)):
            native.decode_image_file(bad, (8, 8, 3))

    def test_jpeg_flows_through_iterator_end_to_end(self, tmp_path):
        from PIL import Image

        paths = []
        labels = np.zeros((8, 2), np.float32)
        for i in range(8):
            p = tmp_path / f"img_{i}.jpg"
            Image.fromarray(np.roll(self._src_image(), i, axis=1)).save(
                p, quality=92)
            paths.append(p)
            labels[i, i % 2] = 1.0
        it = native.image_files_iterator(paths, labels, (48, 64, 3), 2,
                                         batch_size=4, crop=(32, 32),
                                         shuffle=False, augment=False,
                                         directory=tmp_path / "staged")
        batches = list(it)
        assert len(batches) == 2
        f0 = np.asarray(batches[0].features)
        assert f0.shape == (4, 32, 32, 3) and f0.dtype == np.float32
        want = native.decode_image_file(paths[0], (48, 64, 3))
        want = want[8:40, 16:48].astype(np.float32) / 255.0
        np.testing.assert_allclose(f0[0], want, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(batches[0].labels)[0],
                                      labels[0])
        # the staged files equal the JAX package's staging of the same
        jax_native.stage_image_files(paths, labels, tmp_path / "jax",
                                     (48, 64, 3))
        assert ((tmp_path / "staged" / "images.u8").read_bytes()
                == (tmp_path / "jax" / "images.u8").read_bytes())


class TestU8PipelineMode:
    def _staged(self, tmp_path, n=32, hw=40):
        rng = np.random.default_rng(3)
        imgs = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
        labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
        return write_image_dataset(tmp_path, imgs, labels)

    def test_u8_matches_f32_after_device_normalize(self, tmp_path):
        """u8 batches through ``normalize`` on the CPU equal the workers'
        f32 batches within 2e-6 (the JAX test's bound), and equal the JAX
        package's ``normalize`` of the same batch within 2e-6."""
        img_path, label_path = self._staged(tmp_path)
        mean, std = [0.45, 0.44, 0.47], [0.27, 0.26, 0.28]
        kw = dict(crop=(32, 32), shuffle=True, augment=True, seed=11,
                  mean=mean, std=std)
        it_f = NativeImageDataSetIterator(img_path, label_path, 32,
                                          (40, 40, 3), 5, 8, output="f32",
                                          **kw)
        it_u = NativeImageDataSetIterator(img_path, label_path, 32,
                                          (40, 40, 3), 5, 8, output="u8",
                                          device="cpu", **kw)
        it_j = jax_native.NativeImageDataSetIterator(
            img_path, label_path, 32, (40, 40, 3), 5, 8, output="u8", **kw)
        assert it_f.native == it_u.native
        for ds_f, ds_u in zip(it_f, it_u, strict=True):
            assert ds_u.features.dtype == np.uint8
            norm = it_u.normalize(ds_u.features)
            assert isinstance(norm, torch.Tensor)
            assert norm.dtype == torch.float32
            np.testing.assert_allclose(norm.numpy(), ds_f.features,
                                       rtol=2e-6, atol=2e-6)
            np.testing.assert_allclose(
                norm.numpy(), np.asarray(it_j.normalize(ds_u.features)),
                rtol=2e-6, atol=2e-6)
            np.testing.assert_array_equal(ds_f.labels, ds_u.labels)

    def test_u8_epoch_count_and_reset(self, tmp_path):
        img_path, label_path = self._staged(tmp_path)
        it = NativeImageDataSetIterator(img_path, label_path, 32,
                                        (40, 40, 3), 5, 8, crop=(32, 32),
                                        output="u8")
        assert sum(1 for _ in it) == 4
        it.reset()
        assert sum(1 for _ in it) == 4
        it.close()


@pytest.mark.cuda
def test_pinned_side_stream_prefetch_on_the_card(tmp_path):
    """device_prefetch on the card: batches arrive on the device from
    pinned buffers, equal to the host iterator's, and normalize there."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    img_path, label_path = TestU8PipelineMode()._staged(tmp_path)
    kw = dict(crop=(32, 32), shuffle=False, augment=False, output="u8",
              mean=[0.5] * 3, std=[0.25] * 3)
    host = NativeImageDataSetIterator(img_path, label_path, 32, (40, 40, 3),
                                      5, 8, **kw)
    card = NativeImageDataSetIterator(img_path, label_path, 32, (40, 40, 3),
                                      5, 8, device_prefetch=True, **kw)
    for h, c in zip(host, card, strict=True):
        assert c.features.is_cuda
        np.testing.assert_array_equal(c.features.cpu().numpy(), h.features)
        np.testing.assert_allclose(card.normalize(c.features).cpu().numpy(),
                                   host.normalize(h.features).cpu().numpy(),
                                   rtol=2e-6, atol=2e-6)
