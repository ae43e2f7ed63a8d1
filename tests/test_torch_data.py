"""Port parity for the data sources: `ClassificationTask`, `MmapTokenDataset`
and `TokenPipeline(source=...)` give the JAX package's batches bit for bit
for the same seed and stream."""
import json

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import ClassificationTask as JClassificationTask
from repro.data import MmapTokenDataset as JMmapTokenDataset
from repro.data import PipelineConfig as JPipelineConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro_torch.configs import get_config
from repro_torch.data import (ClassificationTask, MmapTokenDataset, PipelineConfig,
                              TokenPipeline, TokenTask)


def _same(got: torch.Tensor, expect) -> None:
    expect = np.asarray(expect)
    assert got.device.type == "cpu"
    assert got.numpy().dtype == expect.dtype, (got.dtype, expect.dtype)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("kw", [{}, dict(seed=3, n_classes=4, dim=16, depth=1,
                                         label_noise=0.0, train_pool=100)])
def test_classification_task_is_bit_identical(kw):
    task, jtask = ClassificationTask(**kw), JClassificationTask(**kw)
    for start in (0, 2):
        got = list(task.train_batches(32, 3, start=start, device="cpu"))
        expect = list(jtask.train_batches(32, 3, start=start))
        assert len(got) == len(expect) == 3
        for b, jb in zip(got, expect):
            _same(b["x"], jb["x"])
            _same(b["y"], jb["y"])
    valid, jvalid = task.valid_set(300, device="cpu"), jtask.valid_set(300)
    _same(valid["x"], jvalid["x"])
    _same(valid["y"], jvalid["y"])
    assert valid["x"].dtype == torch.float32 and valid["y"].dtype == torch.int32


@pytest.fixture
def token_file(tmp_path):
    """A token file written by the port and the same tokens written by the
    reference: the two files and sidecars are the same bytes."""
    tokens = (np.arange(10_000, dtype=np.int64) * 7919) % 97
    path, jpath = tmp_path / "toks.bin", tmp_path / "jtoks.bin"
    MmapTokenDataset.write(path, tokens, vocab_size=97)
    JMmapTokenDataset.write(jpath, tokens, vocab_size=97)
    assert path.read_bytes() == jpath.read_bytes()
    assert (json.loads(path.with_suffix(".json").read_text())
            == json.loads(jpath.with_suffix(".json").read_text())
            == {"vocab_size": 97, "n_tokens": 10_000})
    return path


@pytest.mark.parametrize("seed,stream", [(3, 5), (0, 0), (7, 12)])
def test_mmap_dataset_batches_are_bit_identical(token_file, seed, stream):
    ds, jds = MmapTokenDataset(token_file, seed=seed), JMmapTokenDataset(token_file, seed=seed)
    assert len(ds) == len(jds) == 10_000 and ds.vocab_size == jds.vocab_size == 97
    b, jb = ds.batch(4, 32, stream), jds.batch(4, 32, stream)
    for k in ("tokens", "labels"):
        assert b[k].shape == (4, 32) and b[k].dtype == np.int32
        np.testing.assert_array_equal(b[k], np.asarray(jb[k]))
    # labels are the next tokens of the same windows
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_mmap_dataset_shorter_than_a_sequence_raises(tmp_path):
    path = tmp_path / "short.bin"
    MmapTokenDataset.write(path, np.arange(20), vocab_size=20)
    with pytest.raises(ValueError, match="shorter than one sequence"):
        MmapTokenDataset(path).batch(2, 19, 0)


@pytest.mark.parametrize("ascent_fraction", [0.0, 0.25])
def test_pipeline_over_mmap_source_is_bit_identical(token_file, ascent_fraction):
    jcfg, cfg = jax_get_config("olmo-1b", reduced=True), get_config("olmo-1b", reduced=True)
    kw = dict(global_batch=8, seq_len=32, seed=3, ascent_fraction=ascent_fraction, prefetch=0)
    pipe = TokenPipeline(cfg, PipelineConfig(**kw), device="cpu",
                         source=MmapTokenDataset(token_file, seed=3))
    jpipe = JTokenPipeline(jcfg, JPipelineConfig(**kw),
                           source=JMmapTokenDataset(token_file, seed=3))
    it, jit_ = iter(pipe), iter(jpipe)
    for _ in range(3):
        b, jb = next(it), next(jit_)
        assert ("ascent" in b) == ("ascent" in jb) == bool(ascent_fraction)
        for sub, jsub in ((b, jb), (b.get("ascent"), jb.get("ascent"))):
            if sub is None:
                continue
            for k in ("tokens", "labels"):
                _same(sub[k], jsub[k])
    # the default source is still the synthetic stream
    assert isinstance(TokenPipeline(cfg, PipelineConfig(**kw), device="cpu").source, TokenTask)


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy())


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-tiny"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_stub_inputs_are_bit_identical(arch, reduced):
    """The vision and audio stub inputs, the reference's `_family_extras`,
    through the pipeline (descent and ascent lanes, three steps): the same
    bits in the compute dtype (fp32 reduced, bf16 full)."""
    jcfg, cfg = jax_get_config(arch, reduced=reduced), get_config(arch, reduced=reduced)
    kw = dict(global_batch=4, seq_len=24 if reduced else 640, seed=5, ascent_fraction=0.25,
              prefetch=0)
    it = iter(TokenPipeline(cfg, PipelineConfig(**kw), device="cpu"))
    jit_ = iter(JTokenPipeline(jcfg, JPipelineConfig(**kw)))
    name = "patch_embeds" if cfg.vision is not None else "enc_frames"
    for _ in range(3):
        b, jb = next(it), next(jit_)
        for sub, jsub in ((b, jb), (b["ascent"], jb["ascent"])):
            assert set(sub) - {"ascent"} == set(jsub) - {"ascent"} == {"tokens", "labels", name}
            for k in ("tokens", "labels"):
                _same(sub[k], jsub[k])
            got, expect = sub[name], jsub[name]
            assert got.dtype == getattr(torch, cfg.compute_dtype)
            assert tuple(got.shape) == tuple(expect.shape)
            np.testing.assert_array_equal(_bits(got), _jbits(expect))
