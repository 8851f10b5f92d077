"""Port parity: NeuralPathSim checkpoints across the two packages.

- The port's msgpack codec (models/flax_msgpack.py) against flax's
  bytes, both directions: the port writes flax's bytes for the same
  state dict, and reads what flax writes (and flax reads what it
  writes).
- A checkpoint the JAX package saved loads in the port, and one the
  port saved loads in the JAX package, with every array equal; a JAX
  checkpoint loaded and saved again by the port keeps its blobs byte
  for byte.
- Resumed training across packages: 10 JAX steps saved, then 5 more in
  each package from that checkpoint agree to ``rtol=1e-4``; the same
  from a checkpoint the port re-saved.
- The pre-r04 and ``opt_format`` refusals with the JAX messages.
- ``index build --embedding learned`` from a JAX-saved model: the
  port's corpus embeddings within ``atol=1e-5`` of the JAX package's.
- ``neural_cli`` train / query on a written synthetic GEXF against the
  JAX package's ``neural_cli`` output.
"""

import json
import re
import zipfile

import jax
import numpy as np
import pytest
from flax import serialization

from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu.models.neural import NeuralPathSim as JNeural
from distributed_pathsim_tpu_torch.models import flax_msgpack
from distributed_pathsim_tpu_torch.models.neural import NeuralPathSim
from torch_port_util import write_cli_gexf


@pytest.fixture(scope="module")
def jmodel(tmp_path_factory):
    """A JAX model trained 10 steps and its checkpoint."""
    model = JNeural(jsyn(200, 300, 16, seed=5), "APVPA", dim=16, hidden=32,
                    lr=3e-3, seed=0)
    model.train(steps=10, batch_size=256, seed=0)
    path = str(tmp_path_factory.mktemp("neural") / "jax.npz")
    model.save(path)
    return model, path


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(_np(a))
    lb, tb = jax.tree_util.tree_flatten(_np(b))
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_codec_against_flax_bytes(jmodel):
    model, _ = jmodel
    for target in (model.state.params, model.state.opt_state):
        state = serialization.to_state_dict(target)
        theirs = serialization.to_bytes(target)
        assert flax_msgpack.packb(_np(state)) == theirs
        _leaves_equal(flax_msgpack.unpackb(theirs), state)
        _leaves_equal(serialization.msgpack_restore(
            flax_msgpack.packb(_np(state))), state)
    # scalars, empty maps, a 0-d count, big bins, numpy scalars (ext 3);
    # keys sorted, as flax's tree copy orders them
    doc = dict(sorted({
        "a": {}, "count": np.asarray(7, np.int32), "f": 1.5, "i": -70000,
        "s": "x" * 300, "b": b"\x01" * 70000, "n": None, "t": True,
        "big": np.arange(20000, dtype=np.float32).reshape(100, 200),
        "scalar": np.float64(2.5)}.items()))
    theirs = serialization.msgpack_serialize(dict(doc))
    assert flax_msgpack.packb(doc) == theirs
    back = flax_msgpack.unpackb(theirs)
    assert back["scalar"] == 2.5 and back["count"].shape == ()
    np.testing.assert_array_equal(back["big"], doc["big"])
    assert (back["a"], back["b"], back["i"], back["n"]) == (
        {}, doc["b"], -70000, None)
    import msgpack

    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.unpackb(msgpack.packb(msgpack.ExtType(2, b"xy")))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(theirs[:-3])


def test_checkpoints_load_across_packages(jmodel, tmp_path):
    model, path = jmodel
    port = NeuralPathSim.load(path, device="cpu")
    assert port.state.step == model.state.step == 10
    assert int(port.state.opt_state.count) == 10
    assert port.target_scale == model.target_scale
    assert (port._config, port.variant) == (model._config, model.variant)
    np.testing.assert_array_equal(port._quad_t, model._quad_t)
    np.testing.assert_array_equal(port.features, model.features)
    np.testing.assert_allclose(port.embeddings(), model.embeddings(),
                               atol=1e-5)
    # load and save again: the JAX file's entries, byte for byte
    resaved = str(tmp_path / "resaved.npz")
    port.save(resaved)
    with zipfile.ZipFile(path) as a, zipfile.ZipFile(resaved) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    # a port-trained checkpoint loads in JAX with every array equal
    port.train(steps=3, batch_size=128, seed=2)
    ours = str(tmp_path / "port.npz")
    port.save(ours)
    back = JNeural.load(ours)
    assert back.state.step == 13 and not list(tmp_path.glob("*.tmp*"))
    with np.load(ours) as z:
        params = flax_msgpack.unpackb(z["params"].tobytes())
        opt = flax_msgpack.unpackb(z["opt_state"].tobytes())
    _leaves_equal(back.state.params, params)
    _leaves_equal(serialization.to_state_dict(back.state.opt_state), opt)
    np.testing.assert_allclose(back.embeddings(), port.embeddings(),
                               atol=1e-5)


def test_resume_across_packages(jmodel, tmp_path):
    _, path = jmodel
    ref = JNeural.load(path).train(steps=5, batch_size=256, seed=42)
    got = NeuralPathSim.load(path, device="cpu").train(
        steps=5, batch_size=256, seed=42)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    # through a checkpoint the port wrote: both packages continue alike
    ours = str(tmp_path / "port.npz")
    NeuralPathSim.load(path, device="cpu").save(ours)
    a = JNeural.load(ours).train(steps=5, batch_size=256, seed=9)
    b = NeuralPathSim.load(ours, device="cpu").train(
        steps=5, batch_size=256, seed=9)
    np.testing.assert_allclose(b, a, rtol=1e-4)


def test_old_formats_refused_with_the_jax_messages(jmodel, tmp_path):
    _, path = jmodel
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    old = dict(payload)
    del old["target_scale"], old["quad_t"], old["quad_w"]
    config = json.loads(payload["config"].tobytes().decode())
    other = dict(payload, config=np.frombuffer(json.dumps(
        {**config, "opt_format": "adam-mse-v1"}).encode(), np.uint8))
    for name, arrays in (("pre_r04.npz", old), ("opt.npz", other)):
        p = str(tmp_path / name)
        np.savez_compressed(p, **arrays)
        with pytest.raises(ValueError) as ours:
            NeuralPathSim.load(p, device="cpu")
        with pytest.raises(ValueError) as theirs:
            JNeural.load(p)
        assert str(ours.value) == str(theirs.value)
        assert ("pre-r04" if name == "pre_r04.npz" else "optimizer format") \
            in str(ours.value)


def test_index_build_learned_from_a_jax_model(jmodel):
    from distributed_pathsim_tpu.index.build import (
        learned_embeddings as jlearned,
    )
    from distributed_pathsim_tpu_torch.index.build import learned_embeddings

    model, path = jmodel
    got = learned_embeddings(path, model.n, device="cpu")
    assert got.dtype == np.float32 and got.shape == (model.n, 16)
    np.testing.assert_allclose(got, jlearned(path, model.n), atol=1e-5)
    with pytest.raises(ValueError) as ours:
        learned_embeddings(path, model.n + 1, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jlearned(path, model.n + 1)
    assert str(ours.value) == str(theirs.value)


def test_neural_cli_train_and_query_match_jax(tmp_path, capsys):
    from distributed_pathsim_tpu import neural_cli as jcli
    from distributed_pathsim_tpu_torch import neural_cli as tcli

    gexf = write_cli_gexf(tmp_path / "g.gexf")
    train = ["train", "--dataset", gexf, "--steps", "30", "--batch", "256",
             "--dim", "16", "--hidden", "32", "--mine", "48", "--mine-k",
             "16", "--platform", "cpu"]

    def run(main, argv):
        rc = main(argv)
        out = capsys.readouterr()
        return rc, out.out, out.err

    loss = re.compile(r"loss [0-9.]+ -> [0-9.]+")
    texts = []
    for main, name in ((jcli.main, "j.npz"), (tcli.main, "t.npz")):
        rc, out, _ = run(main, [*train, "--out", str(tmp_path / name)])
        assert rc == 0
        texts.append(loss.sub("loss", out.replace(name, "")))
    assert texts[0] == texts[1] and "Trained 30 steps on 350 author" in \
        texts[0]
    # queries through both CLIs on both checkpoints: the struct index and
    # the exact rerank (struct prefilter, and learned over every row)
    # print the same text
    queries = (["--index", "struct"], ["--index", "rerank"],
               ["--index", "rerank", "--prefilter", "learned",
                "--candidates", "349"])
    for name in ("j.npz", "t.npz"):
        for q in queries:
            argv = ["query", "--model", str(tmp_path / name), "--dataset",
                    gexf, "--source-id", "author_3", "--top-k", "5",
                    "--platform", "cpu", *q]
            want = run(jcli.main, argv)
            assert want[0] == 0 and want[1].count("\n") == 6
            assert run(tcli.main, argv) == want, (name, q)
        # the learned index alone: the same scores to f32 rounding
        argv = ["query", "--model", str(tmp_path / name), "--source-id",
                "3", "--index", "learned", "--top-k", "5", "--platform",
                "cpu"]
        _, want, _ = run(jcli.main, argv)
        _, got, _ = run(tcli.main, argv)
        assert got.splitlines()[0] == want.splitlines()[0]
        np.testing.assert_allclose(
            [float(x.split()[0]) for x in got.splitlines()[1:]],
            [float(x.split()[0]) for x in want.splitlines()[1:]],
            rtol=1e-4, atol=2e-6)
    # the same errors
    for argv in (["query", "--model", str(tmp_path / "t.npz"),
                  "--source-id", "999", "--platform", "cpu"],
                 ["query", "--model", str(tmp_path / "missing.npz"),
                  "--source-id", "1", "--platform", "cpu"]):
        want = run(jcli.main, argv)
        assert want[0] == 1 and run(tcli.main, argv) == want
