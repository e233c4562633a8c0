"""The port's native data path (tpu_hpc_torch.native) against the JAX
package's: the readers' batches, the written corpus and image-record
files, rank-0 preparation over a gloo world of 2, the loud build, and
batch ownership under a non-blocking copy.

Every comparison is exact: the same C++ source reads the same file
with the same seed, so batches agree byte for byte (labels of the image
adapter in value: the port's are int64, the JAX adapter's int32), and
both writers write the same bytes for the same inputs.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Sequential reads, a jump (served synchronously), the read after it
# (reseeks the ring), a jump back into the first epoch, and the next.
STEPS = (0, 1, 2, 9, 10, 11, 3, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast,
    and leaves the other cores to the test files running beside this
    one under xdist (timing-based tests among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jnative():
    pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc import native

    if not native.native_available():
        pytest.skip("the JAX loader could not build its library")
    return native


def _token_corpus(tmp_path, n=5000, vocab=50000, seed=0):
    from tpu_hpc_torch.native import write_token_dataset

    tokens = np.random.default_rng(seed).integers(0, vocab, n)
    return write_token_dataset(str(tmp_path / "tokens.bin"), tokens), tokens


def _records(tmp_path, n=37, seed=1):
    from tpu_hpc_torch.native import write_dataset

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4, 3)).astype(np.float32)
    y = rng.standard_normal((n, 2)).astype(np.float32)
    return write_dataset(str(tmp_path / "records.bin"), x, y), x, y


def _pair(kind, tmp_path, jnative):
    """(port dataset, JAX dataset) over the same file and seed."""
    from tpu_hpc_torch import native

    if kind == "token":
        path, _ = _token_corpus(tmp_path)
        return (native.NativeTokenDataset(path, 3, 16, seed=5),
                jnative.NativeTokenDataset(path, 3, 16, seed=5))
    if kind == "file":
        path, _, _ = _records(tmp_path)
        return (native.NativeFileDataset(path, 4, (4, 3), (2,), seed=3),
                jnative.NativeFileDataset(path, 4, (4, 3), (2,), seed=3))
    return (native.NativeERA5Stream(2, lat=5, lon=7, channels=3, seed=4),
            jnative.NativeERA5Stream(2, lat=5, lon=7, channels=3, seed=4))


@pytest.mark.parametrize("kind", ["token", "file", "era5"])
def test_batches_equal_jax_byte_for_byte(kind, tmp_path, jnative):
    port, ref = _pair(kind, tmp_path, jnative)
    try:
        for step in STEPS:
            got = port.batch_at(step, port.batch_size)
            want = ref.batch_at(step, ref.batch_size)
            for g, w in zip(got, want):
                assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
                assert g.numpy().dtype == w.dtype
                assert g.numpy().tobytes() == w.tobytes(), (kind, step)
        # The ring's own sequential reads agree too.
        for _ in range(3):
            for g, w in zip(port.next(), ref.next()):
                assert g.numpy().tobytes() == w.tobytes()
    finally:
        port.close()
        ref.close()


def test_token_dataset_header_contract(tmp_path, jnative):
    from tpu_hpc_torch.native import NativeTokenDataset

    path, tokens = _token_corpus(tmp_path)
    port = NativeTokenDataset(path, 3, 16)
    ref = jnative.NativeTokenDataset(path, 3, 16)
    assert (port.n_tokens, port.n_windows, port.max_token_id) == (
        ref.n_tokens, ref.n_windows, ref.max_token_id)
    assert port.max_token_id == int(tokens.max())
    port.close()
    ref.close()
    with pytest.raises(ValueError, match="corpus too short"):
        NativeTokenDataset(path, 1, 5000)
    with pytest.raises(FileNotFoundError):
        NativeTokenDataset(str(tmp_path / "missing.bin"), 1, 4)


def test_writers_write_the_jax_bytes(tmp_path, jnative):
    from tpu_hpc_torch.native import write_dataset, write_token_dataset

    rng = np.random.default_rng(2)
    for name, tokens in (("u16", rng.integers(0, 60000, 999)),
                         ("u32", rng.integers(0, 2 ** 20, 999))):
        a = write_token_dataset(str(tmp_path / f"p_{name}"), tokens)
        b = jnative.write_token_dataset(str(tmp_path / f"j_{name}"), tokens)
        assert open(a, "rb").read() == open(b, "rb").read()
    x = rng.standard_normal((9, 2, 2)).astype(np.float32)
    y = rng.integers(0, 10, (9, 1)).astype(np.float32)
    a = write_dataset(str(tmp_path / "p.rec"), x, y)
    b = jnative.write_dataset(str(tmp_path / "j.rec"), x, y)
    assert open(a, "rb").read() == open(b, "rb").read()


def _texts(tmp_path, seed=3):
    """Three documents of seeded text, multi-byte UTF-8 included."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefgh ijklmnop\nqrstuvwxyz.,") + ["é", "ß", "漢", "🙂"]
    paths = []
    for i, n in enumerate((1500, 7, 40000)):
        text = "".join(rng.choice(alphabet, n))
        p = tmp_path / f"doc{i}.md"
        p.write_text(text, encoding="utf-8")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("append_eot", [True, False])
def test_prepare_corpus_writes_the_jax_file(tmp_path, jnative, append_eot):
    from tpu_hpc.native import prepare as jprepare

    from tpu_hpc_torch.native import prepare

    paths = _texts(tmp_path)
    a = prepare.prepare_corpus(str(tmp_path / "p.bin"), paths,
                               append_eot=append_eot)
    b = jprepare.prepare_corpus(str(tmp_path / "j.bin"), paths,
                                append_eot=append_eot)
    assert {k: v for k, v in a.items() if k != "path"} == {
        k: v for k, v in b.items() if k != "path"}
    assert open(a["path"], "rb").read() == open(b["path"], "rb").read()
    # Streamed in small chunks, the byte tokenizer gives the same file.
    chunked = list(prepare.iter_documents(paths[:1], chunk_bytes=64))
    assert "".join(chunked) == open(paths[0], encoding="utf-8").read()


def test_prepare_cli_and_tokenizer_specs(tmp_path, capsys):
    from tpu_hpc_torch.native import prepare

    paths = _texts(tmp_path)
    out = str(tmp_path / "cli.bin")
    assert prepare.main([*paths, "--out", out]) == 0
    assert "tokens" in capsys.readouterr().err
    enc, vocab, eot = prepare.resolve_tokenizer("byte")
    assert (vocab, eot) == (257, 256)
    with pytest.raises(ValueError, match="unknown tokenizer"):
        prepare.resolve_tokenizer("bpe")
    with pytest.raises(ValueError, match="not a local directory"):
        prepare.resolve_tokenizer(f"hf:{tmp_path / 'nope'}")


def test_prepare_digits_writes_the_jax_records(tmp_path, jnative):
    pytest.importorskip("sklearn", reason="scikit-learn's bundled digits")
    from tpu_hpc.native import vision as jvision

    from tpu_hpc_torch.native import vision

    a = vision.prepare_digits(str(tmp_path / "p" / "digits"), seed=1)
    b = jvision.prepare_digits(str(tmp_path / "j" / "digits"), seed=1)
    assert a == b
    for ext in (".train", ".test"):
        assert (open(tmp_path / "p" / f"digits{ext}", "rb").read()
                == open(tmp_path / "j" / f"digits{ext}", "rb").read())
    port = vision.NativeImageClassDataset(
        str(tmp_path / "p" / "digits.train"), 16, tuple(a["x_shape"]))
    ref = jvision.NativeImageClassDataset(
        str(tmp_path / "j" / "digits.train"), 16, tuple(b["x_shape"]))
    for step in (0, 5, 1):
        (px, py), (jx, jy) = port.batch_at(step, 16), ref.batch_at(step, 16)
        assert px.shape == (16, 8, 8, 1)  # NHWC, the models' boundary
        assert px.numpy().tobytes() == jx.tobytes()
        assert py.dtype == torch.int64
        np.testing.assert_array_equal(py.numpy(), jy)
    port.close()
    ref.close()


def test_prepare_digits_at_scale_writes_the_jax_records(tmp_path, jnative):
    pytest.importorskip("sklearn", reason="scikit-learn's bundled digits")
    pytest.importorskip("scipy", reason="the augmentation's affine warp")
    from tpu_hpc.native import vision as jvision

    from tpu_hpc_torch.native import vision

    kw = dict(n_train=24, n_test=8, size=16, seed=2)
    a = vision.prepare_digits_at_scale(str(tmp_path / "p" / "s"), **kw)
    b = jvision.prepare_digits_at_scale(str(tmp_path / "j" / "s"), **kw)
    assert a == b and a["x_shape"] == [16, 16, 1]
    for ext in (".train", ".test"):
        assert (open(tmp_path / "p" / f"s{ext}", "rb").read()
                == open(tmp_path / "j" / f"s{ext}", "rb").read())


def test_prepare_digits_from_npz(tmp_path, jnative):
    from tpu_hpc.native import vision as jvision

    from tpu_hpc_torch.native import vision

    rng = np.random.default_rng(4)
    npz = tmp_path / "set.npz"
    np.savez(npz, x=rng.random((30, 6, 5)).astype(np.float32),
             y=rng.integers(0, 3, 30))
    a = vision.main(["--out", str(tmp_path / "p" / "s"), "--npz", str(npz)])
    b = jvision.prepare_digits(str(tmp_path / "j" / "s"), npz_path=str(npz))
    assert a == 0
    assert vision.read_meta(str(tmp_path / "p" / "s")) == b
    assert (open(tmp_path / "p" / "s.train", "rb").read()
            == open(tmp_path / "j" / "s.train", "rb").read())


def test_a_failed_build_raises(tmp_path, monkeypatch):
    from tpu_hpc_torch.native import dataloader

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="native dataloader build failed"):
        dataloader.build(bad, tmp_path / "lib.so")
    # The loader has no quiet fallback: a dataset over a broken source
    # raises where the JAX package would have said native_available()
    # False.
    monkeypatch.setattr(dataloader, "SOURCE", bad)
    monkeypatch.setattr(dataloader, "LIBRARY", tmp_path / "lib2.so")
    monkeypatch.setattr(dataloader, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        dataloader.NativeERA5Stream(1, lat=2, lon=2, channels=1)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="cannot run g\\+\\+"):
        dataloader.build(bad, tmp_path / "lib3.so")


def test_library_builds_outside_the_package():
    from tpu_hpc_torch.native import dataloader

    dataloader.load_library()
    assert dataloader.LIBRARY.exists()
    assert "build" in dataloader.LIBRARY.parts
    assert not list((dataloader.SOURCE.parent.parent).glob("*.so"))


def test_a_batch_survives_the_ring_advancing(tmp_path):
    """The Trainer copies each batch to the device with
    non_blocking=True: the ring must never refill memory a batch in
    flight still reads. Each batch owns its buffers, so a batch read
    first keeps its bytes while the ring moves on past its depth."""
    from tpu_hpc_torch.native import NativeTokenDataset

    path, _ = _token_corpus(tmp_path)
    ds = NativeTokenDataset(path, 3, 16, seed=1, prefetch_depth=2)
    first = ds.batch_at(0, 3)
    kept = [t.clone() for t in first]
    copies = [t.to("cpu", non_blocking=True) for t in first]
    later = [ds.batch_at(i, 3) for i in range(1, 9)]
    ptrs = {t.data_ptr() for b in (first, *later) for t in b}
    assert len(ptrs) == 2 * (1 + len(later))
    for t, k, c in zip(first, kept, copies):
        assert torch.equal(t, k) and torch.equal(c, k)
    # A fresh synchronous read of step 0 is the same batch.
    again = NativeTokenDataset(path, 3, 16, seed=1).batch_at(0, 3)
    assert all(torch.equal(a, k) for a, k in zip(again, kept))
    ds.close()


def _world_main(workdir):
    """One rank of the gloo world (run as a script): rank 0 prepares
    the files, every rank then reads them."""
    from tpu_hpc_torch.native import prepare_on_host0
    from tpu_hpc_torch.runtime import cleanup_distributed, init_distributed

    info = init_distributed(device="cpu", verbose=False)
    r = info.process_id
    paths = [os.path.join(workdir, "a.txt"), os.path.join(workdir, "b.txt")]
    calls = []

    def prepare():
        calls.append(r)
        for p in paths:
            with open(p, "w") as f:
                f.write("prepared by rank 0")

    prepare_on_host0(prepare, paths)
    seen = [open(p).read() for p in paths]
    # A second round finds the files and prepares nothing.
    prepare_on_host0(prepare, paths)
    with open(os.path.join(workdir, f"rank{r}.json"), "w") as f:
        json.dump({"calls": calls, "seen": seen}, f)
    cleanup_distributed()


def test_prepare_on_host0_over_a_gloo_world(tmp_path):
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), str(tmp_path)], 2,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert ranks[0]["calls"] == [0] and ranks[1]["calls"] == []
    assert all(r["seen"] == ["prepared by rank 0"] * 2 for r in ranks)


def test_train_cli_refuses_a_corpus_past_the_vocabulary(tmp_path, capsys):
    from tpu_hpc_torch.native import write_token_dataset
    from tpu_hpc_torch.train import __main__ as tmain

    path = write_token_dataset(str(tmp_path / "c.bin"),
                               np.arange(400) % 200)
    with pytest.raises(SystemExit) as e:
        # Windows of 32 tokens: the corpus opens, and its largest id
        # is what the run refuses.
        tmain.main(["--device", "cpu", "--vocab", "128", "--seq-len", "32",
                    "--tokens-file", path])
    assert e.value.code == 2
    assert "token id 199 >= vocab_size 128" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tmain.main(["--device", "cpu", "--sp-mode", "ring",
                    "--tokens-file", path])


def test_train_cli_refuses_a_file_that_is_no_corpus(tmp_path, capsys):
    from tpu_hpc_torch.train import __main__ as tmain

    path = tmp_path / "notes.txt"
    path.write_bytes(b"not a corpus" * 100)
    with pytest.raises(SystemExit) as e:
        tmain.main(["--device", "cpu", "--vocab", "128", "--tokens-file",
                    str(path)])
    assert e.value.code == 2
    assert "--tokens-file: corpus" in capsys.readouterr().err


def test_train_from_a_token_file_serves_the_readers_windows(
        tmp_path, capsys, monkeypatch):
    """run_train --tokens-file trains on NativeTokenDataset's batches:
    the batches the reader handed the trainer equal a fresh reader's
    batch_at, step by step."""
    from tpu_hpc_torch.native import NativeTokenDataset, write_token_dataset
    from tpu_hpc_torch.train import __main__ as tmain

    path = write_token_dataset(str(tmp_path / "c.bin"),
                               np.random.default_rng(0).integers(0, 128,
                                                                 3000))
    served = []
    batch_at = NativeTokenDataset.batch_at

    def recording(self, step, batch_size):
        x, y = batch_at(self, step, batch_size)
        served.append((step, x.clone(), y.clone()))
        return x, y

    monkeypatch.setattr(NativeTokenDataset, "batch_at", recording)
    assert tmain.main([
        "--device", "cpu", "--dim", "64", "--n-layers", "2", "--n-heads",
        "4", "--vocab", "128", "--multiple-of", "16", "--seq-len", "32",
        "--steps", "2", "--epochs", "2", "--batch", "4",
        "--grad-accum-steps", "2", "--tokens-file", path]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    corpus = out["corpus"]
    assert corpus["n_tokens"] == 3000 and corpus["n_windows"] == 93
    assert corpus["windows_served"] == 4 * 4
    assert "served" not in corpus  # the line carries counts only
    monkeypatch.undo()
    fresh = NativeTokenDataset(path, 4, 32)
    for step, x, y in served:
        want_x, want_y = fresh.batch_at(step, 4)
        assert torch.equal(x, want_x) and torch.equal(y, want_y)
    fresh.close()
    assert [s for s, _, _ in served] == [0, 1, 2, 3]
    assert all(np.isfinite(out["losses"]))


if __name__ == "__main__":
    _world_main(sys.argv[1])
