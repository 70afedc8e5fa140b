"""The port's checkpoints against the JAX package's, on the CPU.

`repro_torch.checkpoint` writes the reference's layout with its own
MessagePack subset (`checkpoint.codec`): the codec's bytes equal
`msgpack.packb(obj, use_bin_type=True)`'s and it reads what `msgpack`
writes; a checkpoint file written by the port is byte-for-byte the one
the reference writes for the same values; trees cross in both
directions, the training state {"params", "opt"} with the `OptState`
paths among them.  Values: equal (bytes are copied, and a restore casts
only where the template's dtype differs).
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest_step
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro_torch import interop, tree
from repro_torch.checkpoint import (codec, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.optim import optimizers as O

CPU = torch.device("cpu")

# ints at every boundary of MessagePack's integer forms
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63]
OBJECTS = [
    "", "a" * 31, "b" * 32, "c" * 255,
    "d" * 256, "é" * 40, "x" * 70000, b"", b"\x00" * 255, b"\x01" * 256,
    b"\x02" * 70000, bytearray(b"xyz"), [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i, {"k": b"v"}] for i in range(16)},
    {str(i): i for i in range(70000)},
    {"step": 300, "arrays": {"a/b": {"dtype": "float32", "shape": [2, 3],
                                     "data": b"\x00" * 24}}},
] + INTS


@pytest.mark.parametrize("i", range(len(OBJECTS)))
def test_codec_writes_msgpack_bytes_and_reads_them(i):
    obj = OBJECTS[i]
    want = msgpack.packb(obj, use_bin_type=True)
    assert codec.packb(obj) == want
    back = codec.unpackb(want)
    if isinstance(obj, (bytes, bytearray)):
        assert bytes(back) == bytes(obj)
    elif isinstance(obj, dict) and obj and isinstance(
            next(iter(obj.values())), list):
        assert {k: [v[0], {"k": bytes(v[1]["k"])}] for k, v in back.items()} \
            == obj
    elif i == len(OBJECTS) - len(INTS) - 1:
        assert bytes(back["arrays"]["a/b"]["data"]) == b"\x00" * 24
        assert back["step"] == 300
    else:
        assert back == obj


def test_codec_refuses_what_checkpoints_do_not_use():
    for obj in (None, True, 0.5):
        with pytest.raises(ValueError, match="unsupported"):
            codec.unpackb(msgpack.packb(obj, use_bin_type=True))
        with pytest.raises(TypeError, match="cannot pack"):
            codec.packb(obj)
    for data in (b"\xca\x3f\xc0\x00\x00",  # float32 1.5
                 b"\xd4\x01\x00"):            # fixext 1
        with pytest.raises(ValueError, match="unsupported"):
            codec.unpackb(data)
    with pytest.raises(ValueError, match="after the object"):
        codec.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(b"\xc4\x05ab")
    with pytest.raises(TypeError, match="cannot pack"):
        codec.packb({1, 2})
    with pytest.raises(OverflowError):
        codec.packb(2**64)


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16),
                       "c": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    tree_ = _tree()
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, tree_)
    path = save_checkpoint(d, 12, tree_)
    assert path.endswith("step_00000012.msgpack")
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["step_00000007.msgpack", "step_00000012.msgpack"]  # no .tmp left
    assert latest_step(d) == 12
    step, restored = restore_checkpoint(d, template=tree_)
    assert step == 12
    for a, b in zip(tree.leaves(tree_), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    step, flat = restore_checkpoint(d, step=7)
    assert step == 7 and sorted(flat) == ["a", "nested/b", "nested/c"]
    assert flat["nested/b"].dtype == torch.bfloat16
    # a template of another dtype casts
    _, cast = restore_checkpoint(d, template={"a": torch.zeros(
        (2, 3), dtype=torch.float64)})
    assert cast["a"].dtype == torch.float64
    assert torch.equal(cast["a"], tree_["a"].double())


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"a": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, template={"a": torch.ones((3, 3))})


def test_checkpoint_missing_leaf_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"a": torch.ones(2)})
    with pytest.raises(KeyError, match="missing leaf b"):
        restore_checkpoint(d, template={"a": torch.ones(2),
                                        "b": torch.ones(2)})


def test_checkpoint_no_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nonexistent"))
    assert latest_step(str(tmp_path / "nonexistent")) is None
    (tmp_path / "empty").mkdir()
    assert latest_step(str(tmp_path / "empty")) is None


def _train_state(state_dtype):
    """The reference's reduced granite parameters with an AdamW state after
    one update, as JAX trees, and the port's copies."""
    cfg = j_get_config("granite-8b").reduced()
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    opt = JO.adamw(1e-3, state_dtype=state_dtype)
    grads = jax.tree.map(lambda p: 0.01 * jnp.ones_like(p), jp)
    _, jstate = opt.update(grads, opt.init(jp), jp)
    jtree = {"params": jp, "opt": jstate}
    np_tree = jax.tree.map(np.asarray, jtree)
    mine = {"params": interop.lm_params(np_tree["params"], CPU),
            "opt": interop.opt_state(np_tree["opt"], CPU)}
    return jtree, mine


@pytest.mark.parametrize("state_dtype", [None, "bf16"])
def test_port_checkpoint_is_the_reference_file(tmp_path, state_dtype):
    """The same values written by each package give the same file, and
    each restores the other's."""
    jtree, mine = _train_state(jnp.bfloat16 if state_dtype else None)
    j_save(str(tmp_path / "jax"), 5, jtree)
    save_checkpoint(str(tmp_path / "port"), 5, mine)
    name = "step_00000005.msgpack"
    assert (tmp_path / "jax" / name).read_bytes() == \
        (tmp_path / "port" / name).read_bytes()
    paths = [k for k, _ in tree.flatten_with_path(mine)]
    assert "opt/step" in paths and "opt/mu/blocks/attn/wq" in paths
    # the port's file into the reference's template
    assert j_latest_step(str(tmp_path / "port")) == 5
    step, back = j_restore(str(tmp_path / "port"), template=jtree)
    assert step == 5
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the reference's file into the port's template
    template = {"params": tree.tree_map(torch.zeros_like, mine["params"]),
                "opt": O.adamw(1e-3, state_dtype=(
                    torch.bfloat16 if state_dtype else None)).init(
                        mine["params"])}
    step, got = restore_checkpoint(str(tmp_path / "jax"), template=template)
    assert step == 5 and isinstance(got["opt"], O.OptState)
    for (k, a), (_, b) in zip(tree.flatten_with_path(got),
                              tree.flatten_with_path(mine)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_port_template_restore_is_on_the_template_device(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"a": torch.ones(3)})
    _, got = restore_checkpoint(d, template={"a": torch.empty(
        3, device="meta")})
    assert got["a"].device.type == "meta"
