"""The port's Orbax checkpoints (`interop/ocdbt.py`, `interop/orbax.py`,
`train/checkpoints.py`) against the JAX package's, on the CPU, one torch
thread. Reads and writes are exact: every leaf bit for bit.

  (a) a hiera_test SAM2-UNet (rfb_out=8) saved by the JAX `save_variables`
      is read by the port's `restore_variables` exactly; the port's forward
      on it equals the JAX forward under `force_xla` to 2e-5 of max |output|
      (fp32; the frameworks sum in other orders).
  (b) the port's `save_variables` is read by the JAX `restore_variables`
      exactly, and a database whose node limit forces interior nodes by
      tensorstore.
  (c) every manifest and node the port decodes equals
      `tensorstore.ocdbt.dump`'s: the JAX-written directory (the top-level
      database and the per-process one it merges), the port-written one,
      and tensorstore-written ones with interior B-tree and version-tree
      nodes.
  (d) a leaf of more than one chunk, a leaf left at its fill value, an
      uncompressed leaf, each chunk written by tensorstore's zarr layer.
  (e) a full-width hiera_s tree (612 leaves, 36.75 M parameters) of seeded
      numpy leaves, both ways.
  (f) the test, eval, train and export CLIs with --device cpu --checkpoint
      <a directory the JAX package saved>: the same outputs as from the
      `.pth` of the same weights (test CLI PNGs byte for byte).
  (g) a corrupted byte in a manifest or a node fails its checksum; a
      missing chunk without a fill value, an unknown compressor and a tree
      that does not map strictly fail the load; a missing libzstd names it.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
from PIL import Image

from sam2unet_torch.cli import eval_cli, export_cli, test_cli, train_cli
from sam2unet_torch.cli.common import build_model, load_checkpoint
from sam2unet_torch.configs import HIERA_TEST as PORT_HIERA_TEST
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.interop import ocdbt, orbax
from sam2unet_torch.interop.from_jax import jax_to_state_dict, state_dict_to_jax
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_torch.train import checkpoints as port_ckpt
from sam2unet_tpu.configs import HIERA_TEST, SAM2UNetConfig
from sam2unet_tpu.models.sam2unet import SAM2UNet
from sam2unet_tpu.ops.pallas import dispatch as jax_dispatch
from sam2unet_tpu.train import checkpoints as jax_ckpt

SIZE, RFB = 64, 8
# fp32 on both sides: the frameworks sum in other orders (the model tests
# measured 2.6e-6 of max |output|): 2e-5 of max |output|
JAX_REL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, where torch's own pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict)
                   else {prefix + (k,): np.asarray(v)})
    return out


def _assert_same_tree(got: dict, want: dict) -> None:
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert np.array_equal(g[k], w[k]), k


def _noisy(shapes, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX hiera_test SAM2-UNet and seeded variables (every leaf
    noise, BN variances positive)."""
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST, rfb_out=RFB))
    shapes = jax.eval_shape(
        lambda r, x: model.init(r, x, train=False), jax.random.PRNGKey(0),
        np.zeros((1, SIZE, SIZE, 3), np.float32))
    variables = _noisy(dict(shapes), 0)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: np.abs(v) + 0.5, variables["batch_stats"])
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def jax_dir(jax_model, tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "SAM2-UNet_epoch-latest"
    jax_ckpt.save_variables(str(path), jax_model[1])
    return path


# ----------------------------------------------------------------- (a)


def test_jax_checkpoint_reads_exactly_and_runs_the_jax_forward(jax_model,
                                                               jax_dir):
    model, variables = jax_model
    got = port_ckpt.restore_variables(str(jax_dir))
    _assert_same_tree(got, variables)
    assert (jax_dir / "ocdbt.process_0" / ocdbt.MANIFEST_NAME).is_file()

    port = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST, rfb_out=RFB)).eval()
    port.load_state_dict(jax_to_state_dict(got, port.state_dict().keys()),
                         strict=True)
    x = np.random.default_rng(1).standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32)
    with jax_dispatch.force_xla():
        want = jax.jit(lambda v, a: model.apply(v, a, train=False))(
            variables, x)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    for g, w in zip(out, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= JAX_REL * np.abs(w).max()


def test_restore_with_a_template_holds_its_leaves(jax_model, jax_dir):
    template = jax.tree_util.tree_map(lambda v: v.astype(np.float16),
                                      jax_model[1])
    got = port_ckpt.restore_variables(str(jax_dir), template)
    assert all(v.dtype == np.float16 for v in _flat(got).values())
    bad = dict(template, extra={"x": np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match="unexpected|missing"):
        port_ckpt.restore_variables(str(jax_dir), bad)


# ----------------------------------------------------------------- (b)


def test_port_checkpoint_reads_exactly_in_the_jax_package(jax_model,
                                                          tmp_path):
    variables = jax_model[1]
    path = tmp_path / "port_ckpt"
    port_ckpt.save_variables(str(path), variables)
    _assert_same_tree(jax.tree_util.tree_map(
        np.asarray, jax_ckpt.restore_variables(str(path))), variables)
    # and again over the first: the directory is replaced
    port_ckpt.save_variables(str(path), {"params": variables["params"]})
    assert set(jax_ckpt.restore_variables(str(path))) == {"params"}


def _kvstore(root: Path):
    """tensorstore's view of the database at `root` (its configuration from
    the manifest there, or tensorstore's defaults for a new one)."""
    return ts.KvStore.open(f"file://{root}/|ocdbt:").result()


@pytest.mark.parametrize("node_bytes", [ocdbt.MAX_DECODED_NODE_BYTES, 2048])
def test_port_database_reads_in_tensorstore(tmp_path, node_bytes):
    """All sizes of value, inline and in the data file, one leaf node or
    (2048-byte nodes) several levels of interior nodes."""
    rng = np.random.default_rng(3)
    items = {f"k/{i:04d}/{'x' * (i % 7)}".encode():
             rng.bytes(int(rng.integers(0, 3000))) for i in range(300)}
    ocdbt.write_database(tmp_path, items, max_decoded_node_bytes=node_bytes)
    kv = _kvstore(tmp_path)
    assert sorted(kv.list().result()) == sorted(items)
    assert all(kv[k] == v for k, v in items.items())
    db = ocdbt.Database(tmp_path)
    root = db.manifest.versions[0]
    assert (root.root_height > 0) == (node_bytes == 2048)
    assert {k: db.value(k) for k in db.entries} == items


# ----------------------------------------------------------------- (c)


def _fmt_ref(ref: ocdbt.Ref, kind: str) -> str:
    return f"{kind}:{ref.file.base}:{ref.file.relative}:{ref.offset}:{ref.length}"


def _stats(s: ocdbt.Statistics) -> dict:
    return {"num_indirect_value_bytes": s.num_indirect_value_bytes,
            "num_keys": s.num_keys, "num_tree_bytes": s.num_tree_bytes}


def _as_dump(m: ocdbt.Manifest) -> dict:
    """A decoded manifest in `tensorstore.ocdbt.dump`'s form."""
    c = m.config
    config = {"max_decoded_node_bytes": c.max_decoded_node_bytes,
              "max_inline_value_bytes": c.max_inline_value_bytes,
              "uuid": c.uuid.hex(),
              "version_tree_arity_log2": c.version_tree_arity_log2}
    if c.zstd_level is not None:
        config["compression"] = ({"id": "zstd"} if c.zstd_level == 0 else
                                 {"id": "zstd", "level": c.zstd_level})
    versions = []
    for v in m.versions:
        root = {"statistics": _stats(v.statistics)}
        if v.root is not None:
            root["location"] = _fmt_ref(v.root, "btreenode")
        versions.append({"commit_time": v.commit_time,
                         "generation_number": v.generation, "root": root,
                         "root_height": v.root_height})
    nodes = [{"commit_time": n.commit_time, "generation_number": n.generation,
              "height": n.height,
              "location": _fmt_ref(n.location, "versionnode"),
              "num_generations": n.num_generations}
             for n in m.version_tree_nodes]
    return {"config": config, "version_tree_nodes": nodes,
            "versions": versions}


def _node_as_dump(n: ocdbt.Node) -> dict:
    entries = []
    for e in n.entries:
        if n.height:
            entries.append({"key": e.key,
                            "location": _fmt_ref(e.location, "btreenode"),
                            "statistics": _stats(e.statistics),
                            "subtree_common_prefix":
                                e.key[: e.subtree_common_prefix_length]})
        elif isinstance(e.value, ocdbt.Ref):
            entries.append({"indirect_value": _fmt_ref(e.value, "value"),
                            "key": e.key})
        else:
            entries.append({"inline_value": e.value, "key": e.key})
    return {"entries": entries, "height": n.height}


def _check_against_dump(root: Path) -> int:
    """Every manifest and node of the database at `root` against
    tensorstore's dump; returns the nodes compared."""
    kv = ts.KvStore.open(f"file://{root}/").result()
    assert _as_dump(ocdbt.decode_manifest(
        (root / ocdbt.MANIFEST_NAME).read_bytes())) == ts.ocdbt.dump(kv).result()
    db = ocdbt.Database(root)
    stack = [(v.root, v.root_height) for v in db.manifest.versions if v.root]
    count = 0
    while stack:
        ref, height = stack.pop()
        node = ocdbt.decode_node(db.read(ref))
        assert node.height == height
        assert _node_as_dump(node) == ts.ocdbt.dump(
            kv, _fmt_ref(ref, "btreenode")).result()
        count += 1
        if height:
            stack += [(e.location, height - 1) for e in node.entries]
    return count


def test_decoded_manifests_and_nodes_equal_tensorstore_dump(jax_dir, jax_model,
                                                            tmp_path):
    assert _check_against_dump(jax_dir) == 1
    assert _check_against_dump(jax_dir / "ocdbt.process_0") >= 1
    port_ckpt.save_variables(str(tmp_path / "port"), jax_model[1])
    assert _check_against_dump(tmp_path / "port") == 1
    # tensorstore's own: interior B-tree nodes (it takes the 4096-byte node
    # limit from the empty database's manifest), then an interior
    # version-tree node (more than 2**4 versions) and an empty first root
    ocdbt.write_database(tmp_path / "a", {}, max_decoded_node_bytes=4096)
    kv = _kvstore(tmp_path / "a")
    with ts.Transaction() as txn:
        for i in range(300):
            kv.with_transaction(txn)[f"p/q/key{i:05d}"] = b"v%d" % i * (i % 50)
    assert _check_against_dump(tmp_path / "a") > 2
    kv = _kvstore(tmp_path / "b")
    for i in range(20):
        kv[f"k{i}"] = b"x" * i
    _check_against_dump(tmp_path / "b")
    assert ocdbt.Database(tmp_path / "b").manifest.version_tree_nodes


# ----------------------------------------------------------------- (d)


def test_chunked_and_fill_value_leaves_written_by_tensorstore(tmp_path):
    rng = np.random.default_rng(4)
    multi = rng.standard_normal((7, 9)).astype(np.float32)
    raw = rng.integers(-5, 5, (5, 3)).astype(np.int32)
    kv = _kvstore(tmp_path)

    def array(name, shape, dtype, chunks, fill, compressor):
        """A zarr array whose .zarray this test writes; tensorstore opens it
        and writes its chunks."""
        kv[f"{name}/.zarray"] = json.dumps({
            "chunks": chunks, "compressor": compressor,
            "dimension_separator": ".", "dtype": dtype, "fill_value": fill,
            "filters": None, "order": "C", "shape": shape,
            "zarr_format": 2}).encode()
        return ts.open(f"file://{tmp_path}/|ocdbt:{name}/|zarr2:").result()

    zstd = {"id": "zstd", "level": 1}
    array("params.multi", [7, 9], "<f4", [3, 4], None, zstd).write(
        multi).result()
    array("params.fill", [4, 6], "<f4", [2, 6], 1.5, zstd)   # never written
    part = array("params.part", [4], "<f4", [2], "NaN", zstd)
    part[:2].write(np.array([1.0, 2.0], np.float32)).result()
    array("params.raw", [5, 3], "<i4", [5, 3], None, None).write(raw).result()
    leaves = ("multi", "fill", "part", "raw")
    (tmp_path / orbax.METADATA).write_text(json.dumps({
        "tree_metadata": {repr(("params", k)): {
            "key_metadata": [{"key": "params", "key_type": 2},
                             {"key": k, "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}} for k in leaves},
        "use_ocdbt": True, "use_zarr3": False}))
    db = ocdbt.Database(tmp_path)
    assert b"params.multi/2.2" in db.entries
    assert not any(k.startswith(b"params.fill/") and not k.endswith(b".zarray")
                   for k in db.entries)
    got = orbax.read_tree(tmp_path)["params"]
    np.testing.assert_array_equal(got["multi"], multi)
    np.testing.assert_array_equal(got["fill"], np.full((4, 6), 1.5, np.float32))
    np.testing.assert_array_equal(got["part"], [1.0, 2.0, np.nan, np.nan])
    assert got["raw"].dtype == np.int32
    np.testing.assert_array_equal(got["raw"], raw)


# ----------------------------------------------------------------- (e)


def test_full_width_hiera_s_both_ways(tmp_path):
    model = build_model("sam2_hiera_s", torch.device("cpu"))
    shapes = state_dict_to_jax(model.state_dict())
    variables = _noisy(shapes, 5)
    leaves = _flat(variables)
    assert len(leaves) == 612
    assert sum(v.size for v in leaves.values()) == 36_754_243
    jax_ckpt.save_variables(str(tmp_path / "jax"), variables)
    _assert_same_tree(port_ckpt.restore_variables(str(tmp_path / "jax")),
                      variables)
    port_ckpt.save_variables(str(tmp_path / "port"), variables)
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, jax_ckpt.
                      restore_variables(str(tmp_path / "port"))), variables)
    # and into the port's model, strictly, through the CLIs' loader
    load_checkpoint(model, str(tmp_path / "port"))
    want = jax_to_state_dict(variables, model.state_dict().keys())
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)


# ----------------------------------------------------------------- (f)


def _write_set(root: Path, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 255
        Image.fromarray(img).save(root / "images" / f"s{i}.png")
        Image.fromarray(mask).save(root / "masks" / f"s{i}.png")


@pytest.fixture(scope="module")
def cli_checkpoints(tmp_path_factory):
    """The same seeded hiera_test weights as a .pth and as a directory the
    JAX package's save_variables wrote."""
    d = tmp_path_factory.mktemp("cli")
    torch.manual_seed(0)
    model = build_model("hiera_test", torch.device("cpu"))
    with torch.no_grad():
        for v in model.state_dict().values():
            if v.is_floating_point():
                v.add_(0.05 * torch.randn_like(v))
    state = model.state_dict()
    torch.save(state, d / "model.pth")
    jax_ckpt.save_variables(str(d / "SAM2-UNet_epoch-latest"),
                            state_dict_to_jax(state))
    _write_set(d / "data", 3, 0)
    return d


def test_test_and_eval_clis_take_the_jax_directory(cli_checkpoints):
    d = cli_checkpoints
    reports = {}
    for name, ckpt in (("dir", d / "SAM2-UNet_epoch-latest"),
                       ("pth", d / "model.pth")):
        out = d / f"preds_{name}"
        test_cli.main(test_cli.build_parser().parse_args([
            "--checkpoint", str(ckpt), "--test_image_path",
            str(d / "data" / "images"), "--test_gt_path",
            str(d / "data" / "masks"), "--save_path", str(out), "--size", "64",
            "--model_cfg", "hiera_test", "--device", "cpu"]))
        reports[name] = eval_cli.main(eval_cli.build_parser().parse_args(
            ["--pred_path", str(out), "--gt_path", str(d / "data" / "masks")]))
    for i in range(3):
        assert ((d / "preds_dir" / f"s{i}.png").read_bytes()
                == (d / "preds_pth" / f"s{i}.png").read_bytes())
    assert reports["dir"] == reports["pth"]


def test_train_and_export_clis_take_the_jax_directory(cli_checkpoints,
                                                      monkeypatch):
    monkeypatch.setenv("SAM2UNET_NO_NATIVE_LOADER", "1")
    d = cli_checkpoints
    data = ["--train_image_path", str(d / "data" / "images"),
            "--train_mask_path", str(d / "data" / "masks"),
            "--test_image_path", str(d / "data" / "images"),
            "--test_gt_path", str(d / "data" / "masks"), "--size", "64",
            "--model_cfg", "hiera_test", "--batch_size", "3", "--epoch", "1",
            "--num_workers", "1", "--device", "cpu"]
    stats = {}
    for name, ckpt in (("dir", d / "SAM2-UNet_epoch-latest"),
                       ("pth", d / "model.pth")):
        stats[name] = train_cli.main(train_cli.build_parser().parse_args(
            data + ["--checkpoint", str(ckpt), "--save_path",
                    str(d / f"run_{name}")]))
        export_cli.main(export_cli.build_parser().parse_args([
            "--checkpoint", str(ckpt), "--output", str(d / f"{name}.pt2"),
            "--size", "64", "--model_cfg", "hiera_test", "--device", "cpu"]))
    assert stats["dir"]["losses"] == stats["pth"]["losses"]
    assert (d / "dir.pt2").stat().st_size > 0


# ----------------------------------------------------------------- (g)


def _flip(path: Path, offset: int) -> None:
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x01
    path.write_bytes(bytes(data))


def test_a_corrupted_byte_fails_the_checksum(jax_model, tmp_path):
    for what in ("manifest", "node"):
        path = tmp_path / what
        port_ckpt.save_variables(str(path), jax_model[1])
        if what == "manifest":
            target, offset = path / ocdbt.MANIFEST_NAME, 20
        else:
            root = ocdbt.Database(path).manifest.versions[0].root
            target, offset = path / root.file.path, root.offset + 30
        _flip(target, offset)
        with pytest.raises(ocdbt.OcdbtError, match="checksum"):
            port_ckpt.restore_variables(str(path))


def test_a_load_that_cannot_be_exact_fails(jax_model, tmp_path, monkeypatch):
    variables = jax_model[1]
    path = tmp_path / "c"
    port_ckpt.save_variables(str(path), variables)
    # a chunk missing where the array has no fill value
    db = ocdbt.Database(path)
    items = {k: db.value(k) for k in db.entries}
    items.pop(b"params.head.bias/0")
    shutil.rmtree(path / "d")
    ocdbt.write_database(path, items)
    with pytest.raises(ValueError, match="missing"):
        port_ckpt.restore_variables(str(path))
    # an unknown compressor
    meta = json.loads(items[b"params.head.bias/.zarray"])
    items[b"params.head.bias/0"] = b"\0" * 4
    items[b"params.head.bias/.zarray"] = json.dumps(
        dict(meta, compressor={"id": "blosc"})).encode()
    shutil.rmtree(path / "d")
    ocdbt.write_database(path, items)
    with pytest.raises(ValueError, match="compressor"):
        port_ckpt.restore_variables(str(path))
    # a tree that does not map onto the model: the model keeps its weights
    extra = dict(variables, params=dict(variables["params"],
                                        stray={"kernel": np.ones((2, 2))}))
    port_ckpt.save_variables(str(path), extra)
    port = PortSAM2UNet(PortConfig(trunk=PORT_HIERA_TEST, rfb_out=RFB))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(KeyError, match="stray"):
        load_checkpoint(port, str(path))
    assert all(torch.equal(port.state_dict()[k], v) for k, v in before.items())
    # no libzstd: the error names it
    monkeypatch.setattr(ocdbt.ctypes, "CDLL", lambda name: (_ for _ in ()).throw(
        OSError(f"{name}: cannot open shared object file")))
    ocdbt._zstd.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="libzstd.so.1"):
            ocdbt.zstd_compress(b"x", 1)
    finally:
        monkeypatch.undo()
        ocdbt._zstd.cache_clear()
