"""The port's own copies of the JAX package's framework-free code, held to
their originals on the same inputs: ``Config`` and its CLI parser, the path
set, the weight converter, the semseg scores and the CAM decode, the
ImageNet constants, the PIL rescale and strided sizes, the VOC label
dictionaries and datasets, make_cam's bucketing helpers, the instance
stage's connected components, RLE, ``compress_range``, centroid host
functions, instance AP and COCO export, and train_cam's augmentations
and datasets. The port
imports none of the originals (tests/test_torch_imports.py); this file
imports both sides. The CRF copies are held in tests/test_torch_crf.py."""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from irn_tpu.data import transforms as jax_transforms
from irn_tpu.eval import semseg as jax_semseg
from irn_tpu.ops import paths as jax_paths
from irn_tpu.pipeline import run as jax_run
from irn_tpu.pipeline.config import Config as JaxConfig
from irn_tpu.utils import weights as jax_weights
from irn_tpu_torch.data import transforms
from irn_tpu_torch.models.irn import IRNet
from irn_tpu_torch.ops import paths
from irn_tpu_torch.pipeline import run as port_run
from irn_tpu_torch.pipeline import stages_eval
from irn_tpu_torch.pipeline.config import Config
from irn_tpu_torch.utils import weights


def test_config_fields_and_defaults():
    port = [(f.name, f.type, f.default) for f in dataclasses.fields(Config)]
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)]
    assert port == ref


@pytest.mark.parametrize("kw", [
    {},
    {"train_list": "voc12/train.txt", "infer_list": "voc12/val.txt"},
    {"voc12_root": "VOC_ROOT", "val_list": "no/such/list.txt",
     "cls_labels_path": ""},
    {"voc12_root": "VOC_ROOT", "cls_labels_path": "given.npy", "beta": 8},
])
def test_config_resolve(kw, tmp_path):
    """The same resolve() on the same kwargs: the shipped voc12/ lists found
    from another working directory, a root with its own cls_labels.npy."""
    root = tmp_path / "voc"
    root.mkdir()
    (root / "cls_labels.npy").write_bytes(b"")
    kw = {k: (str(root) if v == "VOC_ROOT" else v) for k, v in kw.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        port = dataclasses.asdict(Config(**kw).resolve())
        ref = dataclasses.asdict(JaxConfig(**kw).resolve())
    assert port == ref


def test_parser_options_and_defaults():
    """The port's parser: the JAX parser's option strings, types, actions
    and defaults, plus --device."""
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                         type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    port, ref = table(port_run.build_parser()), table(jax_run.build_parser())
    assert port.pop("device") == (("--device",), "cuda", None, None,
                                  "_StoreAction")
    assert port == ref
    argv = ["--beta", "8", "--cam_scales", "1.0", "0.5", "--no-rw_banded",
            "--make_sem_seg_pass", "--device", "cpu"]
    cfg, device = port_run.parse(argv)
    assert device == "cpu"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_run.config_from_args(argv[:-2]))


@pytest.mark.parametrize("radius", [5, 10])
def test_build_path_set(radius):
    port, ref = paths.build_path_set(radius), jax_paths.build_path_set(radius)
    assert (port.radius, port.radius_floor, port.n_pairs,
            port.max_path_length) == (ref.radius, ref.radius_floor,
                                      ref.n_pairs, ref.max_path_length)
    for name in ("dst_offsets", "cells", "lengths"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(port.paths_by_length) == len(ref.paths_by_length)
    for a, b in zip(port.paths_by_length, ref.paths_by_length):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("with_mean_shift", [True, False])
def test_convert_irn_net(with_mean_shift):
    """A seeded random IRNet state dict through both converters: the same
    keys, shapes, dtypes and values."""
    g = np.random.default_rng(0)
    sd = {k: g.standard_normal(tuple(v.shape)).astype(np.float32)
          for k, v in IRNet().state_dict().items()}
    if not with_mean_shift:
        sd.pop("mean_shift.running_mean")
    port, ref = _flat(weights.convert_irn_net(sd)), _flat(
        jax_weights.convert_irn_net(sd))
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and np.array_equal(
            port[k], ref[k]), k
    # irn_to_jax goes through the port's copy and round-trips
    model = IRNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}
                          | ({} if with_mean_shift else {
                              "mean_shift.running_mean": torch.zeros(2)}))
    back = weights.irn_from_jax(weights.irn_to_jax(model.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_semseg_scores():
    """accumulate_confusion + scores_from_confusion over several images
    with void, negative and out-of-range labels, against
    irn_tpu.eval.semseg."""
    g = np.random.default_rng(1)
    port, ref = np.zeros((21, 21), np.int64), np.zeros((21, 21), np.int64)
    for _ in range(5):
        gt = g.integers(-1, 24, (17, 13))
        gt[g.random(gt.shape) < 0.1] = 255
        pred = g.integers(-1, 23, (17, 13))
        stages_eval.accumulate_confusion(port, pred, gt)
        jax_semseg.accumulate_confusion(ref, pred, gt)
    assert np.array_equal(port, ref)
    port[3] = 0  # a class with an empty union: nan iou
    a = stages_eval.scores_from_confusion(port)
    b = jax_semseg.scores_from_confusion(port)
    assert sorted(a) == sorted(b) and a["miou"] == b["miou"]
    for k in ("iou", "fp", "fn"):
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        stages_eval.accumulate_confusion(port, np.zeros(3), np.zeros(4))


def test_imagenet_constants():
    for port, ref in ((transforms.IMAGENET_MEAN, jax_transforms.IMAGENET_MEAN),
                      (transforms.IMAGENET_STD, jax_transforms.IMAGENET_STD)):
        assert port.dtype == ref.dtype and np.array_equal(port, ref)


@pytest.mark.parametrize("scale,order", [(0.5, 3), (1.5, 3), (2.0, 3),
                                         (1.0, 3), (0.25, 0), (0.7, 0)])
def test_pil_rescale(scale, order):
    g = np.random.default_rng(2)
    img = g.integers(0, 256, (37, 51, 3)).astype(np.uint8)
    if order == 0:
        img = img[..., 0]
    got = transforms.pil_rescale(img, scale, order)
    want = jax_transforms.pil_rescale(img, scale, order)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        transforms.pil_resize(img, (10, 10), 1)


@pytest.mark.parametrize("size", [(1, 1), (37, 51), (500, 375), (64, 64)])
@pytest.mark.parametrize("stride", [4, 16])
def test_strided_sizes(size, stride):
    assert transforms.get_strided_size(size, stride) == \
        jax_transforms.get_strided_size(size, stride)
    assert transforms.get_strided_up_size(size, stride) == \
        jax_transforms.get_strided_up_size(size, stride)


@pytest.mark.parametrize("k", [0, 1, 3])
def test_decode_cam_to_labels(k):
    """Random maps, ties with the background plane and an all-zero image
    (background wherever bg_thres > 0)."""
    g = np.random.default_rng(k)
    cams = g.random((k, 9, 11)).astype(np.float32)
    if k:
        cams[0, :3] = 0.15
    keys = np.sort(g.choice(20, size=k, replace=False))
    for t in (0.0, 0.15, 0.3):
        got = stages_eval.decode_cam_to_labels(cams, keys, t)
        want = jax_semseg.decode_cam_to_labels(cams, keys, t)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    zero = np.zeros_like(cams)
    assert not stages_eval.decode_cam_to_labels(zero, keys, 0.15).any()


def test_round_up_and_chunk_sizes():
    from irn_tpu.pipeline import common as jax_common
    from irn_tpu.pipeline import stages_cam as jax_cam
    from irn_tpu_torch.pipeline import stages_cam

    for x in range(0, 70):
        for m in (1, 16, 64):
            assert stages_cam.round_up(x, m) == jax_common.round_up(x, m)
    for m in range(0, 40):
        for cap in (1, 4, 8, 32):
            assert stages_cam._chunk_sizes(m, cap) == \
                jax_cam._chunk_sizes(m, cap)


def test_voc12_sources(tmp_path):
    """load_label_dict (string and reference-style int keys),
    ImageDataset and ClassificationDataset with img_normal=False, and
    _label_dict from cls_labels.npy or, without it, from the XML
    annotations: the same names, arrays and dtypes as irn_tpu's."""
    from irn_tpu.data import synthetic as jax_synthetic
    from irn_tpu.data import voc12 as jax_voc12
    from irn_tpu.pipeline import stages_cam as jax_cam
    from irn_tpu_torch.data import voc12
    from irn_tpu_torch.pipeline import stages_cam

    root = str(tmp_path / "voc")
    train, _ = jax_synthetic.generate(root, n_images=3, size=24,
                                      max_side_jitter=6, seed=1)
    labels = np.load(os.path.join(root, "cls_labels.npy"),
                     allow_pickle=True).item()
    int_keys = str(tmp_path / "int_keys.npy")
    np.save(int_keys, {int(k.replace("_", "")): v for k, v in labels.items()})
    for path in (os.path.join(root, "cls_labels.npy"), int_keys):
        got, want = voc12.load_label_dict(path), jax_voc12.load_label_dict(path)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])
    port = voc12.ClassificationDataset(train, root, labels, img_normal=False)
    ref = jax_voc12.ClassificationDataset(train, root, labels,
                                          img_normal=False)
    plain = voc12.ImageDataset(train, root, img_normal=False)
    assert len(port) == len(ref) == len(plain)
    for i in range(len(ref)):
        a, b, c = port[i], ref[i], plain[i]
        assert sorted(a) == sorted(b) and sorted(c) == ["img", "name"]
        assert a["name"] == b["name"] == c["name"]
        assert a["img"].dtype == b["img"].dtype == np.uint8
        assert np.array_equal(a["img"], b["img"])
        assert np.array_equal(c["img"], b["img"])
        assert np.array_equal(a["label"], b["label"])

    cfg = Config(voc12_root=root, train_list=train, val_list=train,
                 infer_list=train).resolve()
    jcfg = JaxConfig(voc12_root=root, train_list=train, val_list=train,
                     infer_list=train).resolve()
    for c, jc in ((cfg, jcfg),
                  (dataclasses.replace(cfg, cls_labels_path="none.npy"),
                   dataclasses.replace(jcfg, cls_labels_path="none.npy"))):
        if c.cls_labels_path == "none.npy":
            ann = os.path.join(root, "Annotations")
            os.makedirs(ann, exist_ok=True)
            for i, name in enumerate(voc12.load_img_name_list(train)):
                objs = "".join(f"<object><name>{voc12.CAT_LIST[j]}</name>"
                               f"</object>" for j in (i, 2 * i + 3))
                with open(os.path.join(ann, name + ".xml"), "w") as f:
                    f.write(f"<annotation>{objs}<object><name>void</name>"
                            "</object></annotation>")
        got, want = stages_cam._label_dict(c), jax_cam._label_dict(jc)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]) and got[k].dtype == \
                want[k].dtype


def _init_defaults(cls):
    """{parameter: default} of cls's constructor, with the keywords that a
    ``**kw`` passes on to the base class's constructor."""
    out = {}
    for klass in reversed(cls.__mro__):
        if "__init__" not in vars(klass) or klass is object:
            continue
        for p in inspect.signature(vars(klass)["__init__"]).parameters.values():
            if p.default is not inspect.Parameter.empty:
                out[p.name] = p.default
    return out


@pytest.mark.parametrize("name", ["ImageDataset", "ClassificationDataset"])
def test_dataset_constructor_defaults(name):
    """The port's ImageDataset and ClassificationDataset take the same
    constructor parameters with the same defaults as their JAX originals
    (img_normal True: a caller that wants the uint8 image asks for it)."""
    from irn_tpu.data import voc12 as jax_voc12
    from irn_tpu_torch.data import voc12

    got = _init_defaults(getattr(voc12, name))
    want = _init_defaults(getattr(jax_voc12, name))
    assert got == want and got["img_normal"] is True
    assert list(inspect.signature(getattr(voc12, name)).parameters) == \
        list(inspect.signature(getattr(jax_voc12, name)).parameters)


# -- the instance stage's copies ---------------------------------------------


def _blob_masks(seed):
    rng = np.random.default_rng(seed)
    return {p: rng.random((23, 31)) < p for p in (0.2, 0.5, 0.8)}


@pytest.mark.parametrize("p", [0.2, 0.5, 0.8])
def test_label_components_and_one_hot(p):
    """cc.label_components (the port's native build) and to_one_hot equal
    irn_tpu.ops.cc's; compress_range equals the transforms original."""
    from irn_tpu.ops import cc as jax_cc
    from irn_tpu_torch.ops import cc

    mask = _blob_masks(3)[p]
    lab, k = cc.label_components(mask)
    want_lab, want_k = jax_cc.label_components(mask)
    assert k == want_k and lab.dtype == want_lab.dtype == np.int32
    np.testing.assert_array_equal(lab, want_lab)
    np.testing.assert_array_equal(cc.to_one_hot(lab), jax_cc.to_one_hot(lab))
    np.testing.assert_array_equal(cc.to_one_hot(lab, k + 3),
                                  jax_cc.to_one_hot(lab, k + 3))
    sparse = lab * 7 + 3
    np.testing.assert_array_equal(transforms.compress_range(sparse),
                                  jax_transforms.compress_range(sparse))


@pytest.mark.parametrize("case", ["random", "starts_on", "empty", "full"])
def test_rle_encode_decode(case):
    from irn_tpu.ops import cc as jax_cc
    from irn_tpu_torch.ops import cc

    mask = {"random": _blob_masks(4)[0.5],
            "starts_on": np.eye(9, 13, dtype=bool),
            "empty": np.zeros((5, 6), bool),
            "full": np.ones((5, 6), bool)}[case]
    rle = cc.rle_encode(mask)
    assert rle == jax_cc.rle_encode(mask)
    np.testing.assert_array_equal(cc.rle_decode(rle), mask.astype(np.uint8))
    np.testing.assert_array_equal(cc.rle_decode(rle), jax_cc.rle_decode(rle))


def test_centroids_host_functions(rng):
    """cluster_centroids(_from_basin), mask_scores_by_instance,
    split_components and detect_instance equal irn_tpu.ops.centroids'."""
    from irn_tpu.ops import centroids as jax_centroids
    from irn_tpu_torch.ops import centroids

    dp = (rng.standard_normal((2, 20, 24)) * 2).astype(np.float32)
    cent = np.stack([rng.integers(0, 20, (20, 24)),
                     rng.integers(0, 24, (20, 24))]).astype(np.int32)
    inst = centroids.cluster_centroids(cent, dp)
    np.testing.assert_array_equal(inst,
                                  jax_centroids.cluster_centroids(cent, dp))
    basin = (rng.random((20, 24)) < 0.4).astype(np.uint8)
    np.testing.assert_array_equal(
        centroids.cluster_centroids_from_basin(cent, basin),
        jax_centroids.cluster_centroids_from_basin(cent, basin))
    cams = rng.random((3, 20, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        centroids.mask_scores_by_instance(cams, inst),
        jax_centroids.mask_scores_by_instance(cams, inst))
    labels = np.kron(rng.integers(0, 5, (5, 6)), np.ones((4, 4), int))
    for got, want in zip(centroids.split_components(labels, 4),
                         jax_centroids.split_components(labels, 4)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    scores = rng.random((3, 20, 24)).astype(np.float32)
    masks = np.stack([labels == v for v in (1, 2, 3)])
    got = centroids.detect_instance(scores, masks, np.array([4, 0, 7]), 9)
    want = jax_centroids.detect_instance(scores, masks, np.array([4, 0, 7]), 9)
    for key in ("score", "mask", "class"):
        np.testing.assert_array_equal(got[key], want[key])


def test_instance_ap_and_gt(rng):
    """eval_instance_segmentation_voc (matches, misses, duplicates, an
    image without predictions) and load_voc_instance_gt equal
    irn_tpu.eval.insseg's."""
    from irn_tpu.eval import insseg as jax_insseg
    from irn_tpu_torch.eval import insseg

    obj = np.kron(rng.integers(0, 4, (4, 5)), np.ones((6, 6), np.uint8))
    obj[0, :3] = 255
    cls = np.where(obj > 0, obj * 3 % 20 + 1, 0).astype(np.uint8)
    cls[obj == 255] = 255
    gm, gl = insseg.load_voc_instance_gt(obj, cls)
    want_gm, want_gl = jax_insseg.load_voc_instance_gt(obj, cls)
    np.testing.assert_array_equal(gm, want_gm)
    np.testing.assert_array_equal(gl, want_gl)
    preds = []
    for _ in range(3):
        n = int(rng.integers(0, 5))
        pm = np.stack([gm[int(rng.integers(0, len(gm)))] ^ (
            rng.random(gm.shape[1:]) < 0.05) for _ in range(n)]) if n else (
            np.zeros((0,) + gm.shape[1:], bool))
        preds.append((pm, rng.integers(0, 12, n), rng.random(n)))
    args = ([p[0] for p in preds], [p[1] for p in preds],
            [p[2] for p in preds], [gm] * 3, [gl] * 3)
    got = insseg.eval_instance_segmentation_voc(*args)
    want = jax_insseg.eval_instance_segmentation_voc(*args)
    np.testing.assert_array_equal(got["ap"], want["ap"])
    assert got["map"] == want["map"]


@pytest.mark.parametrize("fmt", ["rle", "polygon"])
def test_coco_export(tmp_path, rng, fmt):
    """export_instances writes irn_tpu.eval.coco's json (polygons traced by
    OpenCV, as the original; the card host has no cv2 and exports rle)."""
    from irn_tpu.eval import coco as jax_coco
    from irn_tpu_torch.eval import coco

    mask = np.zeros((40, 50), bool)
    mask[5:30, 8:40] = True
    mask[12:20, 15:30] = False
    recs = [{"name": "2007_000456", "size": (40, 50),
             "score": np.array([0.9, 1e-6, 0.4]),
             "mask": np.stack([mask, mask, rng.random((40, 50)) < 0.3]),
             "class": np.array([2, 3, 19])}]
    got = coco.export_instances(recs, str(tmp_path / "port.json"),
                                segmentation_format=fmt)
    want = jax_coco.export_instances(recs, str(tmp_path / "jax.json"),
                                     segmentation_format=fmt)
    assert got == want and len(got["annotations"]) == 2
    assert (tmp_path / "port.json").read_text() == (
        tmp_path / "jax.json").read_text()


# -- train_irn's copies -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentations(seed):
    """random_scale, random_lr_flip, random_crop (image and label through
    one box, with fills) and top_left_crop under the same seeded
    generators: the same arrays and the same generator state after."""
    g = np.random.default_rng(seed + 10)
    img = g.integers(0, 256, (45, 61, 3)).astype(np.uint8)
    lab = g.integers(0, 21, (45, 61)).astype(np.uint8)
    for crop in (32, 80):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        a = transforms.random_scale((img, lab), (0.5, 1.5), (3, 0), rng=ra)
        b = jax_transforms.random_scale((img, lab), (0.5, 1.5), (3, 0),
                                        rng=rb)
        a = transforms.random_lr_flip(a, rng=ra)
        b = jax_transforms.random_lr_flip(b, rng=rb)
        a = transforms.random_crop(a, crop, (0, 255), rng=ra)
        b = jax_transforms.random_crop(b, crop, (0, 255), rng=rb)
        single = transforms.random_crop(transforms.normalize(img), crop, 0,
                                        rng=ra)
        want = jax_transforms.random_crop(jax_transforms.normalize(img),
                                          crop, 0, rng=rb)
        for x, y in zip((*a, single), (*b, want)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert ra.random() == rb.random()
        for arr, fill in ((img, 0), (lab, 255)):
            assert np.array_equal(transforms.top_left_crop(arr, crop, fill),
                                  jax_transforms.top_left_crop(arr, crop,
                                                               fill))
        assert transforms.random_crop_box((45, 61), crop, np.random.default_rng(
            seed)) == jax_transforms.random_crop_box(
                (45, 61), crop, np.random.default_rng(seed))


def test_train_datasets_and_loader(tmp_path):
    """AffinityDataset and ImageDataset (the calibration's top-left crops)
    items, and BatchLoader batches (shuffled, drop_last, threads, over two
    epochs through set_epoch; each rank's ``local_rows`` too), equal to
    irn_tpu's for the same seed."""
    from irn_tpu.data import loader as jax_loader
    from irn_tpu.data import synthetic as jax_synthetic
    from irn_tpu.data import voc12 as jax_voc12
    from irn_tpu_torch.data import loader, voc12

    root = str(tmp_path / "voc")
    train, _ = jax_synthetic.generate(root, n_images=6, size=40,
                                      max_side_jitter=30, seed=2)
    with open(train, "w") as f:
        f.write("\n".join(f"2007_{i:06d}" for i in range(6)) + "\n")
    label_dir = os.path.join(root, "SegmentationClass")
    kw = dict(crop_size=32, rescale=(0.5, 1.5), hor_flip=True,
              crop_method="random")
    port = voc12.AffinityDataset(train, label_dir, voc12_root=root, **kw)
    ref = jax_voc12.AffinityDataset(train, label_dir, voc12_root=root, **kw)
    pairs = [
        (port, ref),
        (voc12.ImageDataset(train, root, img_normal=True, crop_size=32,
                            crop_method="top_left"),
         jax_voc12.ImageDataset(train, root, crop_size=32,
                                crop_method="top_left")),
        (voc12.ImageDataset(train, root, img_normal=True, rescale=(0.5, 1.5),
                            hor_flip=True, crop_size=32,
                            crop_method="random", seed=3),
         jax_voc12.ImageDataset(train, root, rescale=(0.5, 1.5),
                                hor_flip=True, crop_size=32,
                                crop_method="random", seed=3)),
    ]
    for p, r in pairs:
        for epoch in (0, 1):
            p.set_epoch(epoch)
            r.set_epoch(epoch)
            for i in range(len(r)):
                a, b = p[i], r[i]
                assert sorted(a) == sorted(b)
                for k in b:
                    if isinstance(b[k], np.ndarray):
                        assert a[k].dtype == b[k].dtype, k
                        assert np.array_equal(a[k], b[k]), (epoch, i, k)
                    else:
                        assert a[k] == b[k]

    dl = loader.BatchLoader(port, 4, shuffle=True, drop_last=True,
                            num_workers=3)
    jdl = jax_loader.BatchLoader(ref, 4, shuffle=True, drop_last=True,
                                 num_workers=3)
    assert len(dl) == len(jdl) == 1
    for epoch in (0, 1):
        dl.set_epoch(epoch)
        jdl.set_epoch(epoch)
        got, want = list(dl), list(jdl)
        assert len(got) == len(want) == 1
        for k in want[0]:
            if isinstance(want[0][k], np.ndarray):
                assert np.array_equal(got[0][k], want[0][k]), k
            else:
                assert got[0][k] == want[0][k]
    # local_rows: each rank's contiguous rows of every global batch, as
    # JAX's loader takes them; the ranks' rows together are the batch
    for epoch in (0, 1):
        rows = []
        for lo, hi in ((0, 2), (2, 4)):
            p = loader.BatchLoader(port, 4, shuffle=True, drop_last=True,
                                   num_workers=2, local_rows=(lo, hi))
            j = jax_loader.BatchLoader(ref, 4, shuffle=True, drop_last=True,
                                       num_workers=2, local_rows=(lo, hi))
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            (got,), (want,) = list(p), list(j)
            for k in want:
                if isinstance(want[k], np.ndarray):
                    assert np.array_equal(got[k], want[k]), (lo, k)
                else:
                    assert got[k] == want[k]
            rows.append(got)
        dl.set_epoch(epoch)
        (full,) = list(dl)
        for k in full:
            joined = (np.concatenate([r[k] for r in rows])
                      if isinstance(full[k], np.ndarray)
                      else rows[0][k] + rows[1][k])
            assert np.array_equal(joined, full[k]), k
    with pytest.raises(ValueError, match="drop_last"):
        loader.BatchLoader(port, 4, local_rows=(0, 2))
    tail = loader.BatchLoader(port, 4, drop_last=False, num_workers=2)
    assert [len(b["name"]) for b in tail] == [4, 2]
    assert loader.collate([{"a": np.zeros(2), "n": "x"},
                           {"a": np.ones(2), "n": "y"}])["n"] == ["x", "y"]
    assert np.array_equal(loader.shard_indices(10, 1, 3),
                          jax_loader.shard_indices(10, 1, 3))


# -- train_cam's copies -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resize_long_and_center_crop(seed):
    """random_resize_long under the same seeded generators (the same array
    and generator state after), and center_crop on images larger and
    smaller than the crop along each side, with fills."""
    g = np.random.default_rng(seed + 20)
    img = g.integers(0, 256, (45, 61, 3)).astype(np.uint8)
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for lo, hi in ((320, 640), (20, 90)):
        a = transforms.random_resize_long(img, lo, hi, rng=ra)
        b = jax_transforms.random_resize_long(img, lo, hi, rng=rb)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert lo <= max(a.shape[:2]) <= hi + 1
    assert ra.random() == rb.random()
    lab = g.integers(0, 21, (45, 61)).astype(np.uint8)
    for crop in (32, 50, 80):
        for arr, fill in ((img, 0), (lab, 255), (img[:, :30], 7)):
            assert np.array_equal(transforms.center_crop(arr, crop, fill),
                                  jax_transforms.center_crop(arr, crop, fill))


def test_train_cam_datasets(tmp_path):
    """ClassificationDataset with train_cam's options (resize_long,
    normalisation, flip, random crop; and the validate set's top-left
    crop) over two epochs, and MultiScaleDataset: the same items as
    irn_tpu's."""
    from irn_tpu.data import synthetic as jax_synthetic
    from irn_tpu.data import voc12 as jax_voc12
    from irn_tpu_torch.data import voc12

    root = str(tmp_path / "voc")
    train, _ = jax_synthetic.generate(root, n_images=3, size=40,
                                      max_side_jitter=20, seed=4)
    labels = voc12.load_label_dict(os.path.join(root, "cls_labels.npy"))
    kw = dict(resize_long=(60, 90), hor_flip=True, crop_size=48,
              crop_method="random")
    pairs = [
        (voc12.ClassificationDataset(train, root, labels, img_normal=True,
                                     **kw),
         jax_voc12.ClassificationDataset(train, root, labels, **kw)),
        (voc12.ClassificationDataset(train, root, labels, img_normal=True,
                                     crop_size=48),
         jax_voc12.ClassificationDataset(train, root, labels, crop_size=48)),
        (voc12.MultiScaleDataset(train, root, labels, scales=(1.0, 0.5)),
         jax_voc12.MultiScaleDataset(train, root, labels,
                                     scales=(1.0, 0.5))),
    ]
    for p, r in pairs:
        for epoch in (0, 1):
            p.set_epoch(epoch)
            r.set_epoch(epoch)
            for i in range(len(r)):
                a, b = p[i], r[i]
                assert sorted(a) == sorted(b)
                assert a["name"] == b["name"]
                assert np.array_equal(a["label"], b["label"])
                imgs_a, imgs_b = a["img"], b["img"]
                if isinstance(imgs_b, np.ndarray):
                    imgs_a, imgs_b = [imgs_a], [imgs_b]
                else:
                    assert a["size"] == b["size"]
                assert len(imgs_a) == len(imgs_b)
                for x, y in zip(imgs_a, imgs_b):
                    assert x.dtype == y.dtype == np.float32
                    assert np.array_equal(x, y), (epoch, i)


def test_average_meter():
    from irn_tpu.utils.logging import AverageMeter as JaxMeter
    from irn_tpu_torch.utils.logging import AverageMeter, DeviceMeter

    a, b = AverageMeter("x"), JaxMeter("x")
    for m in (a, b):
        m.add({"x": 1.5, "y": 2})
        m.add({"x": 2.5})
    assert (a.get("x"), a.get("y")) == (b.get("x"), b.get("y")) == (2.0, 2.0)
    assert a.pop("x") == b.pop("x") == 2.0
    assert a.get("x") == b.get("x") == 0.0
    a.pop()
    assert a.get("y") == 0.0
    d = DeviceMeter()
    d.add({"x": torch.tensor(1.0)})
    d.add({"x": torch.tensor(2.0)})
    assert d.pop("x") == 1.5 and d.pop("x") == 0.0
