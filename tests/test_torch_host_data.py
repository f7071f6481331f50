"""The port's host data (``data/folder.py``, ``coco.py``, ``pipeline.py``,
``native_loader.py``, ``synthetic.py``) against the JAX package's, on the
same files written to disk from a seed."""

import hashlib
import os

import numpy as np
import pytest
import torch
from PIL import Image

from arsvt_tpu.data import native_loader as jax_native
from arsvt_tpu.data import pipeline as jax_pipeline
from arsvt_tpu.data import synthetic as jax_synthetic
from arsvt_tpu.data.coco import CocoDataset as JaxCocoDataset
from arsvt_tpu.data.folder import FolderDataset as JaxFolderDataset
from arsvt_tpu.data.folder import (
    open_classification_split as jax_open_split,
)
from arsvt_tpu_torch.data import native_loader, pipeline, synthetic
from arsvt_tpu_torch.data.coco import CocoDataset
from arsvt_tpu_torch.data.folder import (
    FolderDataset,
    _stable_val_hash,
    open_classification_split,
)
from arsvt_tpu_torch.data.taxonomy import RECYCLING_CLASSES

torch.set_num_threads(1)  # tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((32, 32), (24, 40), (45, 30))  # (height, width): resize and pad


def _write_tree(root, per_class=6, seed=0, classes=RECYCLING_CLASSES):
    rng = np.random.default_rng(seed)
    for label, name in enumerate(classes):
        os.makedirs(os.path.join(root, name))
        for i in range(per_class):
            h, w = SIZES[i % len(SIZES)]
            img = jax_synthetic.synthetic_shape_image(label, max(h, w), rng)
            img = Image.fromarray((img * 255).astype(np.uint8))
            img.resize((w, h)).save(os.path.join(root, name,
                                                 f"{name}{i}.jpg"),
                                    quality=90)
    return str(root)


@pytest.fixture(scope="module")
def unsplit(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("unsplit") / "trashnet")


@pytest.fixture(scope="module")
def presplit(tmp_path_factory):
    root = tmp_path_factory.mktemp("presplit")
    _write_tree(root / "train", per_class=3, seed=1)
    _write_tree(root / "valid", per_class=2, seed=2,
                classes=("Metal", "glass", "zz_other"))
    return str(root)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return synthetic.make_synthetic_coco(
        str(tmp_path_factory.mktemp("coco")), images_per_split=9,
        image_size=40, max_boxes=3)


@pytest.fixture
def pil_on_both(monkeypatch):
    """Pin both packages to the PIL decoder."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native_loader, "available", lambda: False)


def _records(ds):
    return [(r.path, r.label) for r in ds.records]


def test_stable_val_hash_matches_jax():
    from arsvt_tpu.data.folder import _stable_val_hash as jax_hash

    names = [f"/a/{c}/{c}{i}.jpg" for c in RECYCLING_CLASSES
             for i in range(50)]
    assert [_stable_val_hash(n) for n in names] == [jax_hash(n)
                                                     for n in names]
    # the basename alone decides: moving the tree keeps the split
    assert _stable_val_hash("/x/y/glass3.jpg") == _stable_val_hash(
        "/elsewhere/glass3.jpg")


@pytest.mark.parametrize("split", [None, "train", "valid"])
def test_folder_dataset_unsplit_matches_jax(unsplit, split):
    ours, theirs = FolderDataset(unsplit, split=split), JaxFolderDataset(
        unsplit, split=split)
    assert _records(ours) == _records(theirs)
    assert ours.class_names == theirs.class_names == list(RECYCLING_CLASSES)
    assert ours.num_classes == theirs.num_classes == 6
    np.testing.assert_array_equal(ours.classification_labels(),
                                  theirs.classification_labels())
    assert ours.classification_labels().dtype == np.int32


def test_unsplit_train_and_valid_partition_the_tree(unsplit):
    whole = set(_records(FolderDataset(unsplit)))
    train = set(_records(open_classification_split(unsplit, "train")))
    valid = set(_records(open_classification_split(unsplit, "valid")))
    assert train | valid == whole and not train & valid and valid
    assert valid == set(_records(jax_open_split(unsplit, "valid")))
    with pytest.raises(ValueError, match="--split valid"):
        open_classification_split(unsplit, "test")
    with pytest.raises(ValueError, match="split must be"):
        FolderDataset(unsplit, split="test")


@pytest.mark.parametrize("split", ["train", "valid"])
def test_presplit_tree_matches_jax(presplit, split):
    ours, theirs = (open_classification_split(presplit, split),
                    jax_open_split(presplit, split))
    assert _records(ours) == _records(theirs)
    assert ours.class_names == theirs.class_names
    if split == "valid":  # names outside the taxonomy: directory order
        assert ours.class_names == ["metal", "glass", "zz_other"]


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_coco_dataset_matches_jax(coco, split):
    ours = CocoDataset(os.path.join(coco, split))
    theirs = JaxCocoDataset(os.path.join(coco, split))
    assert ours.class_names == theirs.class_names
    assert ours.category_id_to_label == theirs.category_id_to_label
    assert ours.label_to_category_id == theirs.label_to_category_id
    assert len(ours) == len(theirs) == 9
    for a, b in zip(ours.records, theirs.records):
        assert (a.path, a.width, a.height, a.image_id) == (
            b.path, b.width, b.height, b.image_id)
        for k in ("boxes", "labels", "areas", "iscrowd"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.dominant_label == b.dominant_label
    for i in range(len(ours)):
        for m in (1, 4):
            got, ref = ours.padded_target(i, m), theirs.padded_target(i, m)
            assert set(got) == set(ref)
            for k in got:
                assert got[k].dtype == ref[k].dtype
                np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(ours.classification_labels(),
                                  theirs.classification_labels())
    # a COCO split dir is what open_classification_split returns for it
    assert isinstance(open_classification_split(coco, split), CocoDataset)


def _assert_same_batches(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


CLS_CASES = {
    "shuffle": dict(seed=3),
    "skip": dict(seed=5, skip_batches=3),
    "ragged_tail": dict(seed=3, repeat=False, drop_remainder=False),
    "padded_eval": dict(seed=1, repeat=False, shuffle=False,
                        drop_remainder=False, pad_to_equal_batches=True),
    "shard_1_of_2": dict(seed=5, process_index=1, process_count=2),
    "float32": dict(seed=3, image_dtype=np.float32),
}


@pytest.mark.parametrize("case", CLS_CASES, ids=list(CLS_CASES))
def test_classification_batches_match_jax(unsplit, pil_on_both, case):
    """PIL route on both sides: the same images, labels and pad masks,
    byte for byte (numpy's default_rng shuffle, the same letterbox)."""
    kw = dict(batch_size=5, canvas=36, **CLS_CASES[case])
    n = 4 if kw.get("repeat", True) else None
    ds, jds = FolderDataset(unsplit), JaxFolderDataset(unsplit)
    got = list(_take(pipeline.classification_batches(ds, **kw), n))
    ref = list(_take(jax_pipeline.classification_batches(jds, **kw), n))
    _assert_same_batches(got, ref)
    assert got[0]["image"].shape[1:] == (36, 36, 3)


DET_CASES = {
    "shuffle": dict(seed=0),
    "seed_7_skip": dict(seed=7, skip_batches=2),
    "padded_eval": dict(seed=1, repeat=False, shuffle=False,
                        drop_remainder=False, pad_to_equal_batches=True),
    "ragged_tail": dict(seed=7, repeat=False, drop_remainder=False),
}


@pytest.mark.parametrize("case", DET_CASES, ids=list(DET_CASES))
def test_detection_batches_match_jax(coco, pil_on_both, case):
    kw = dict(batch_size=4, canvas=48, max_objects=2, **DET_CASES[case])
    n = 3 if kw.get("repeat", True) else None
    split = os.path.join(coco, "train")
    with pytest.warns(UserWarning, match="max_objects"):
        got = list(_take(pipeline.detection_batches(CocoDataset(split),
                                                    **kw), n))
    with pytest.warns(UserWarning, match="max_objects"):
        ref = list(_take(jax_pipeline.detection_batches(
            JaxCocoDataset(split), **kw), n))
    _assert_same_batches(got, ref)
    assert any(b["mask"].any() for b in got)  # boxes were carried


def _take(it, n):
    out = []
    for batch in it:
        out.append(batch)
        if n is not None and len(out) == n:
            it.close()
            break
    return out


def test_pipeline_argument_checks_match_jax(unsplit):
    ds = FolderDataset(unsplit)
    with pytest.raises(ValueError, match="eval-stream mode"):
        pipeline.classification_batches(ds, batch_size=4, canvas=32,
                                        pad_to_equal_batches=True)
    # a shard that fills no batch raises instead of spinning forever
    it = pipeline.classification_batches(ds, batch_size=10**4, canvas=32)
    with pytest.raises(RuntimeError, match="no batch of 10000"):
        next(it)


def test_prefetcher_propagates_errors_and_closes():
    def failing():
        yield 1
        raise KeyError("boom")

    it = pipeline.Prefetcher(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)
    with pytest.raises(StopIteration):  # exhausted once, stays so
        next(it)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = pipeline.Prefetcher(endless(), depth=2)
    assert [next(it), next(it)] == [0, 1]
    it.close(wait=True)
    assert not it._t.is_alive()
    # what the worker queued before close() drains, then the stream ends
    rest = list(it)
    assert len(rest) <= 2 and rest == list(range(2, 2 + len(rest)))
    assert list(pipeline.Prefetcher(iter(range(5)))) == list(range(5))


def test_make_synthetic_coco_writes_jax_files(tmp_path):
    ours = synthetic.make_synthetic_coco(str(tmp_path / "a"),
                                         images_per_split=5, image_size=48)
    theirs = jax_synthetic.make_synthetic_coco(
        str(tmp_path / "b"), images_per_split=5, image_size=48)

    def digests(root):
        out = {}
        for d, _, files in os.walk(root):
            for f in files:
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
        return out

    got = digests(ours)
    assert got == digests(theirs) and len(got) == 3 * 6


def test_synthetic_shape_batches_match_jax():
    got = synthetic.synthetic_shape_batches(batch_size=3, image_size=24,
                                            seed=4)
    ref = jax_synthetic.synthetic_shape_batches(batch_size=3, image_size=24,
                                                seed=4)
    for _ in range(2):
        a, b = next(got), next(ref)
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["image"], b["image"])


def test_load_image_and_letterbox_match_jax(unsplit):
    path = FolderDataset(unsplit).records[1].path  # 24 x 40: resized
    np.testing.assert_array_equal(pipeline.load_image(path),
                                  jax_pipeline.load_image(path))
    for canvas in (36, 50):
        got, tf = pipeline.letterbox_u8(pipeline.load_image_u8(path), canvas)
        ref, jtf = jax_pipeline.letterbox_u8(jax_pipeline.load_image_u8(path),
                                             canvas)
        np.testing.assert_array_equal(got, ref)
        boxes = np.array([[0.1, 0.2, 0.7, 0.9]], np.float32)
        np.testing.assert_array_equal(tf(boxes), jtf(boxes))


@pytest.fixture
def native_on_both():
    """Decided in the test, not at import: both packages' native builds."""
    if not (native_loader.available() and jax_native.available()):
        pytest.skip("a native decoder is not built")


def test_native_batch_matches_jax_native(coco, unsplit, native_on_both):
    """The same C++ source on both sides: the same bytes and meta."""
    paths = [r.path for r in FolderDataset(unsplit).records[:9]]
    paths += [r.path for r in CocoDataset(os.path.join(coco,
                                                       "train")).records]
    for dtype in (np.uint8, np.float32):
        for scaled in (False, True):  # JPEGs at a libjpeg DCT scale
            got, meta = native_loader.load_letterboxed_batch(
                paths, 16, dtype=dtype, scaled_decode=scaled)
            ref, jmeta = jax_native.load_letterboxed_batch(
                paths, 16, dtype=dtype, scaled_decode=scaled)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(meta, jmeta)
            assert meta.shape == (len(paths), 6 if scaled else 4)
    np.testing.assert_array_equal(native_loader.decode_image(paths[1]),
                                  jax_native.decode_image(paths[1]))
    assert native_loader.route() == "native"
    assert native_loader.build_error() is None


def test_native_matches_pil_within_jax_limit(coco, native_on_both):
    """JAX's own limit between its routes (tests/test_native_loader.py):
    decoder rounding, 2.5/255, at that test's shapes."""
    root = synthetic.make_synthetic_coco(
        os.path.join(os.path.dirname(coco), "nl"), images_per_split=4,
        image_size=40)
    recs = CocoDataset(os.path.join(root, "train")).records
    paths = [r.path for r in recs]
    images, meta = native_loader.load_letterboxed_batch(paths, 64)
    assert (meta[:, 3] == 1.0).all()
    ref = np.stack([pipeline.letterbox(pipeline.load_image(p), 64)[0]
                    for p in paths])
    assert np.abs(images - ref).max() <= 2.5 / 255
    tf = native_loader.box_transform_from_meta(meta[0], 64)
    _, tf_pil = pipeline.letterbox(pipeline.load_image(paths[0]), 64)
    boxes = np.array([[0.1, 0.2, 0.8, 0.9]], np.float32)
    np.testing.assert_allclose(tf(boxes, recs[0].width, recs[0].height),
                               tf_pil(boxes), atol=1e-5)


def test_native_route_batches_match_jax_native_route(coco, native_on_both):
    """Both packages on their native route: detection batches, boxes
    through `box_transform_from_meta`, equal."""
    kw = dict(batch_size=4, canvas=48, max_objects=3, seed=2)
    split = os.path.join(coco, "train")
    got = _take(pipeline.detection_batches(CocoDataset(split), **kw), 2)
    ref = _take(jax_pipeline.detection_batches(JaxCocoDataset(split), **kw),
                2)
    _assert_same_batches(got, ref)


def test_load_letterboxed_single_takes_the_native_decoder(unsplit,
                                                          monkeypatch,
                                                          native_on_both):
    path = FolderDataset(unsplit).records[2].path
    native = pipeline.load_letterboxed_single(path, 40)
    np.testing.assert_array_equal(
        native, native_loader.load_letterboxed_batch(
            [path], 40, dtype=np.uint8)[0][0])
    monkeypatch.setattr(native_loader, "available", lambda: False)
    pil = pipeline.load_letterboxed_single(path, 40)
    np.testing.assert_array_equal(
        pil, pipeline.letterbox_u8(pipeline.load_image_u8(path), 40)[0])


def test_undecodable_file_raises_on_both_routes(tmp_path, monkeypatch):
    bad = tmp_path / "bad.jpg"
    bad.write_text("not an image")
    if native_loader.available():
        with pytest.raises(ValueError, match="undecodable"):
            pipeline.load_letterboxed_single(str(bad), 32)
        with pytest.raises(ValueError, match="failed to decode"):
            pipeline.load_letterboxed([str(bad)], 32)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    with pytest.raises(OSError):
        pipeline.load_letterboxed_single(str(bad), 32)


def _snapshot(directory):
    return sorted((e.name, e.stat().st_size, e.stat().st_mtime_ns)
                  for e in os.scandir(directory))


def test_the_port_never_writes_into_native(tmp_path, monkeypatch):
    """A fresh build reads native/arsvt_loader.cpp alone and writes its
    library under the build directory, never into native/; the library
    there is neither rebuilt nor loaded."""
    native_dir = os.path.join(REPO, "native")
    before = _snapshot(native_dir)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    if native_loader.available():
        built = list((tmp_path / "build").iterdir())
        assert len(built) == 1 and built[0].suffix == ".so"
        loaded = {os.path.realpath(line.split()[-1])
                  for line in open("/proc/self/maps")
                  if line.rstrip().endswith(".so")}
        assert os.path.realpath(built[0]) in loaded
        assert native_loader.route() == "native"
    assert _snapshot(native_dir) == before
    assert str(native_loader.SOURCE) == os.path.join(native_dir,
                                                     "arsvt_loader.cpp")


def test_a_failed_build_takes_the_pil_route(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native_loader.available()
    assert native_loader.route() == "pil"
    assert "no-such-compiler" in native_loader.build_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        native_loader.load_letterboxed_batch(["x.jpg"], 32)
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())
