"""The port's tiny T5 encoder against the JAX package's, and the port's
native sentencepiece binding on a tiny model written in raw wire format."""

import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import perturb
from s2v_tpu.config import T5Config as JT5Config
from s2v_tpu.models import t5 as j_t5
from s2v_torch.config import T5Config
from s2v_torch.loaders.jax_params import t5_from_jax
from s2v_torch.models import t5

# fp32 through 2 blocks with unscaled attention logits; outputs are RMS-normed O(1)
ATOL, RTOL = 1e-4, 1e-4


@pytest.mark.parametrize("seq_len", [16, 40])
def test_t5_encode_matches_jax(seq_len):
    params = perturb(j_t5.init_t5_params(jax.random.PRNGKey(0), JT5Config.tiny()), seed=2, scale=0.05)
    ids = np.random.RandomState(seq_len).randint(0, 128, size=(2, seq_len)).astype(np.int32)
    want = j_t5.t5_encode(params, JT5Config.tiny(), jnp.asarray(ids))
    cfg = T5Config.tiny()
    got = t5.t5_encode(t5_from_jax(params, cfg, device="cpu"), cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_bias_index_matches_jax():
    np.testing.assert_array_equal(t5.build_position_bias_index(300, T5Config()),
                                  j_t5.build_position_bias_index(300, JT5Config()))


def test_random_init_matches_jax_structure():
    cfg = T5Config.tiny()
    mine = t5.init_t5_params_random(cfg, device="cpu")
    theirs = t5_from_jax(jax.tree.map(np.asarray, j_t5.init_t5_params(jax.random.PRNGKey(0), JT5Config.tiny())),
                         cfg, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(mine) == shapes(theirs)


PIECES = [
    ("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -4.0, 1), ("▁a", -2.0, 1),
    ("▁pig", -1.0, 1), ("▁walk", -1.5, 1), ("ing", -1.2, 1), ("▁walking", -3.5, 1),
    ("p", -5.0, 1), ("i", -5.0, 1), ("g", -5.0, 1),
]


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    from s2v_torch.utils.sp_native import NativeSPTokenizer, write_spiece_model

    path = tmp_path_factory.mktemp("sp") / "spiece.model"
    write_spiece_model(path, PIECES)
    tok = NativeSPTokenizer(path)
    tok.model_path = path
    return tok


def test_native_tokenizer_ids(tok):
    assert len(tok) == 13 and tok.cls_id == 12
    assert tok._encode_one("a pig") == [4, 5]
    assert tok._encode_one("walking") == [6, 7]  # walk+ing (-2.7) beats walking (-3.5)
    assert tok._encode_one("a   pig") == tok._encode_one("a pig")
    arr = tok.encode(["<cls> a pig", "a pig walking a pig walking"], max_length=6)
    assert arr.dtype == np.int32 and arr.shape == (2, 6)
    assert list(arr[0]) == [12, 4, 5, 1, 0, 0]
    assert list(arr[1]) == [4, 5, 6, 7, 4, 1]  # truncated to max_length - 1, EOS kept


@pytest.mark.parametrize("prompt", ["café", "a\tpig", "a\x07pig"], ids=["non_ascii", "tab", "bell"])
def test_native_tokenizer_rejects_what_it_cannot_normalize(tok, prompt):
    """The JAX package's guard: only text that nmt_nfkc could change (non-ASCII,
    or NFKC-variant ASCII) leaves the native path, and without a fallback
    tokenizer.json it raises in both packages; ASCII control characters are
    encoded natively, to the same ids in both."""
    from s2v_tpu.utils.sp_native import NativeSPTokenizer as JNativeSPTokenizer

    theirs = JNativeSPTokenizer(str(tok.model_path))
    if prompt == "café":
        for t in (tok, theirs):
            with pytest.raises(ValueError):
                t.encode(prompt)
        return
    np.testing.assert_array_equal(tok.encode(prompt, max_length=8), theirs.encode(prompt, max_length=8))


@pytest.fixture(scope="module")
def tok_with_json(tmp_path_factory):
    """The tiny spiece.model with a tokenizer.json beside it (the tiny
    WordLevel tokenizer of ``tools/make_tiny_snapshot.py``)."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_tiny_snapshot import write_tokenizer

    from s2v_torch.utils.sp_native import write_spiece_model

    d = tmp_path_factory.mktemp("sp_json")
    write_spiece_model(d / "spiece.model", PIECES)
    write_tokenizer(str(d / "tokenizer.json"), 64)
    return d


@pytest.mark.parametrize("prompt", ["café", "a café pig", ["a pig", "un café"]], ids=["word", "sentence", "batch"])
def test_native_tokenizer_reroutes_to_tokenizer_json(tok_with_json, prompt):
    """A prompt nmt_nfkc could change goes to T5CLSTokenizer on the
    tokenizer.json next to the spiece.model, in both packages, to the same ids."""
    from s2v_tpu.utils.sp_native import NativeSPTokenizer as JNativeSPTokenizer
    from s2v_torch.utils.sp_native import NativeSPTokenizer

    model = str(tok_with_json / "spiece.model")
    mine, theirs = NativeSPTokenizer(model), JNativeSPTokenizer(model)
    got, want = mine.encode(prompt, max_length=12), theirs.encode(prompt, max_length=12)
    np.testing.assert_array_equal(got, want)
    assert mine._fallback is not None  # the reroute ran, not the native path
    # ASCII stays on the native path, equal in both
    np.testing.assert_array_equal(mine.encode("a pig", max_length=6), theirs.encode("a pig", max_length=6))
    assert list(mine.encode("a pig", max_length=6)[0]) == [4, 5, 1, 0, 0, 0]
    # an explicit fallback file is taken too
    explicit = NativeSPTokenizer(model, fallback_tokenizer_json=str(tok_with_json / "tokenizer.json"))
    np.testing.assert_array_equal(explicit.encode(prompt, max_length=12), want)


def test_native_tokenizer_logs_truncation(tok):
    import logging

    from s2v_torch.utils.logging import get_logger

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = get_logger("s2v_torch.tokenizer")
    logger.addHandler(handler)
    try:
        ids = tok.encode("a pig walking a pig walking", max_length=4)
        tok.encode("a pig", max_length=4)  # fits: no warning
    finally:
        logger.removeHandler(handler)
    assert list(ids[0]) == [4, 5, 6, 1]
    assert [r.levelname for r in records] == ["WARNING"]
    assert records[0].getMessage() == ("Input truncated because `max_sequence_length` is set to 4 tokens: "
                                       "5 trailing tokens removed")  # a pig walk ing a pig walk ing: 8 ids, 3 kept
