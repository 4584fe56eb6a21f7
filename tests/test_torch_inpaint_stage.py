"""The inpainting stage of the PyTorch port (``preprocess/inpaint.run``,
stage 3) against the JAX stage, end to end on the same files.

Both packages run FLUX.1-Kontext with the reference's tiny configurations
(``FLUX_TINY_TEST``, ``FLUX_VAE_TINY``, ``T5_TINY_TEST``, ``CLIP_TINY_TEST``)
and the same weights (``flax_to_torch``), on two 32x32 HOI crops, one with a
hand mask and an object name. Two changes make the tiny towers fit each other
and the checkpoint tokenizers' ids: CLIP takes 77 positions and the
vocabulary's EOS id, and the transformer's pooled width is CLIP's 32 (the
reference's tiny configurations are not built to run together). The
synthetic vocabularies of ``test_torch_text_towers`` are installed, so both
packages tokenize the prompt alike ([1,77] and [1,512]; the hashed fallback's
ids differ by design). JAX's inpainter is built through ``object.__new__``
and its stage noise (``stage_key(SEED_INPAINT, "inpaint")``, the same for
every image) is injected into the port.

Tolerances (measured on the CPU): the same files; each PNG within 1 of the
JAX one in every channel (float32 on both sides, then the reference's
truncation to uint8, where an output within rounding of an integer step may
land on either side; measured: 1, on one of the two images' 6,144 values). The
Telea backend (``cv2``) gives the same bytes in both packages. The GPU tools'
temporary vocabularies (``tools/_scene.flux_tokenizer_assets``) give the
checkpoint path's shapes and leave ``FOHO_TPU_ASSETS`` as they found it.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_flux import random_params
from test_torch_text_towers import write_clip_vocab, write_t5_vocab

import followmyhold_tpu.ops.attention  # noqa: F401  (imported before any jit traces it)
from followmyhold_tpu.models import clip_text as JC
from followmyhold_tpu.models import flux as JF
from followmyhold_tpu.models import t5 as JT5
from followmyhold_tpu.preprocess import inpaint as JI
from followmyhold_tpu.utils.prng import SEED_INPAINT, stage_key
from followmyhold_tpu_torch.models import clip_text as TC
from followmyhold_tpu_torch.models import flux as TF
from followmyhold_tpu_torch.models import t5 as TT5
from followmyhold_tpu_torch.preprocess import inpaint as TI
from followmyhold_tpu_torch.tools._scene import flux_tokenizer_assets
from followmyhold_tpu_torch.utils.params import flax_to_torch

IDS = ("000031", "000032")
SIZE = 32


@pytest.fixture
def assets(tmp_path, monkeypatch):
    """Synthetic FLUX tokenizer vocabularies under FOHO_TPU_ASSETS. -> the
    CLIP vocabulary."""
    root = tmp_path / "assets"
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(root))
    monkeypatch.delenv("FOHO_ALLOW_HASH_TOKENIZER", raising=False)
    vocab = write_clip_vocab(str(root / "tokenizers" / "flux_clip"))
    write_t5_vocab(str(root / "tokenizers" / "flux_t5"))
    return vocab


def _write_inputs(root):
    """Two HOI crops, a hand mask for the first (in the stage's default mask
    directory) and a Gemini CSV naming its object."""
    crops = os.path.join(root, "cropped_hoi")
    masks = os.path.join(root, "cropped_hand_masks")
    os.makedirs(crops)
    os.makedirs(masks)
    for k, image_id in enumerate(IDS):
        img = np.random.default_rng(10 + k).integers(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(crops, f"{image_id}_cropped_hoi_{k}.png"))
    hand = np.zeros((SIZE, SIZE), np.uint8)
    hand[8:20, 10:22] = 255
    Image.fromarray(hand).save(os.path.join(masks, f"{IDS[0]}_cropped_hand_mask.png"))
    csv_path = os.path.join(root, "gemini.csv")
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write(f"{IDS[0]},yes,water bottle\n")
    return crops, csv_path


def _configs(eos_id):
    clip = dict(max_position_embeddings=77, eos_token_id=eos_id)
    return ((dataclasses.replace(JF.FLUX_TINY_TEST, pooled_dim=32), JF.FLUX_VAE_TINY,
             dataclasses.replace(JC.CLIP_TINY_TEST, **clip), JT5.T5_TINY_TEST),
            (dataclasses.replace(TF.FLUX_TINY_TEST, pooled_dim=32), TF.FLUX_VAE_TINY,
             dataclasses.replace(TC.CLIP_TINY_TEST, **clip), TT5.T5_TINY_TEST))


@functools.lru_cache(maxsize=None)
def _inpainters(eos_id):
    """(JAX inpainter, port inpainter) with the same random tiny weights; the
    JAX models' ``apply`` jitted (the reference calls its towers and VAE
    eagerly, which takes ~10 s for an image on the CPU)."""
    (jf, jv, jc, jt), (tf, tv, tc, tt) = _configs(eos_id)

    def init(model, *args):
        return random_params(lambda k: model.init(k, *args), len(args))

    j = object.__new__(JI.FluxKontextInpainter)
    j.transformer, j.vae = JF.FluxTransformer(jf), JF.FluxVae(jv)
    j.clip, j.t5 = JC.ClipTextModel(jc), JT5.T5Encoder(jt)
    n = 8
    j.t_params = init(j.transformer, jnp.zeros((1, n, jf.in_channels)),
                      jnp.zeros((1, 4, jf.joint_dim)), jnp.zeros((1, jf.pooled_dim)),
                      jnp.ones((1,)), jnp.zeros((n, 3)), jnp.zeros((4, 3)), jnp.ones((1,)))
    j.vae_params = init(j.vae, jnp.zeros((1, SIZE, SIZE, 3)))
    j.clip_params = init(j.clip, jnp.zeros((1, 8), jnp.int32))
    j.t5_params = init(j.t5, jnp.zeros((1, 9), jnp.int32))
    port = TI.FluxKontextInpainter(
        flax_to_torch(j.t_params, TF.FluxTransformer(tf, device="cpu")),
        flax_to_torch(j.vae_params, TF.FluxVae(tv, device="cpu")),
        flax_to_torch(j.clip_params, TC.ClipTextModel(tc, device="cpu")),
        flax_to_torch(j.t5_params, TT5.T5Encoder(tt, device="cpu")))
    for name in ("transformer", "vae", "clip", "t5"):
        setattr(j, name, _Jitted(getattr(j, name)))
    return j, port


class _Jitted:
    """A Flax module's ``cfg`` and its ``apply``, jitted."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.apply = jax.jit(model.apply, static_argnames="method")


def _read_all(d):
    return {name: np.asarray(Image.open(os.path.join(d, name))) for name in sorted(os.listdir(d))}


def test_run_matches_the_jax_stage(assets, tmp_path, monkeypatch, capsys):
    crops, csv_path = _write_inputs(str(tmp_path))
    j, port = _inpainters(assets["<|endoftext|>"])
    monkeypatch.setattr(JI, "_LEARNED", j)
    JI.run(str(tmp_path / "jax"), crops, csv_path)
    noise = np.asarray(jax.random.normal(stage_key(SEED_INPAINT, "inpaint"), (1, 64, 16),
                                         jnp.float32))
    TI.run(str(tmp_path / "port"), crops, csv_path, models=port,
           initial_noise={i: noise for i in IDS}, device="cpu")
    assert "FLUX.1-Kontext on cpu" in capsys.readouterr().out
    want, got = _read_all(str(tmp_path / "jax")), _read_all(str(tmp_path / "port"))
    assert sorted(got) == [f"{IDS[0]}_inpainted_0.png", f"{IDS[1]}_inpainted_1.png"]
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].shape == (SIZE, SIZE, 3) and got[name].dtype == np.uint8
        diff = np.abs(got[name].astype(int) - want[name].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02, (name, diff.max(), (diff > 0).mean())
    # an existing output is skipped
    path = os.path.join(str(tmp_path / "port"), f"{IDS[0]}_inpainted_0.png")
    before = os.path.getmtime(path)
    TI.run(str(tmp_path / "port"), crops, csv_path, models=port, device="cpu")
    assert "exists, skipping" in capsys.readouterr().out and os.path.getmtime(path) == before


def test_the_stage_noise_is_the_same_for_every_image(assets):
    _, port = _inpainters(assets["<|endoftext|>"])
    img = np.random.default_rng(3).integers(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    prompt = "Remove hands but keep the object."
    first, second = port(img, prompt), port(img, prompt)
    np.testing.assert_array_equal(first, second)
    noise = torch.randn((1, 64, 16), generator=torch.Generator().manual_seed(5))
    assert not np.array_equal(port(img, prompt, initial_noise=noise), first)


def test_telea_backend_matches_the_jax_stage(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path / "no_assets"))
    monkeypatch.setattr(JI, "_LEARNED", None)
    crops, csv_path = _write_inputs(str(tmp_path))
    JI.run(str(tmp_path / "jax"), crops, csv_path)
    TI.run(str(tmp_path / "port"), crops, csv_path, device="cpu")
    want, got = _read_all(str(tmp_path / "jax")), _read_all(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) and len(got) == 2
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])
    img = np.asarray(Image.open(os.path.join(crops, f"{IDS[0]}_cropped_hoi_0.png")))
    mask = np.zeros((SIZE, SIZE), bool)
    mask[8:20, 10:22] = True
    filled = TI.inpaint_hand(img, mask)
    np.testing.assert_array_equal(filled, JI.inpaint_hand(img, mask))
    assert not np.array_equal(filled, img)


def test_converted_weights_without_a_loader_raise(tmp_path, monkeypatch):
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path))
    os.makedirs(tmp_path / "params")
    for name in TI.FluxKontextInpainter.REQUIRED:
        (tmp_path / "params" / f"{name}.msgpack").write_bytes(b"x")
    crops, csv_path = _write_inputs(str(tmp_path))
    with pytest.raises(NotImplementedError, match="converters"):
        TI.run(str(tmp_path / "out"), crops, csv_path, device="cpu")


def test_run_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    crops, csv_path = _write_inputs(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.run(str(tmp_path / "out"), crops, csv_path)


def test_flux_tokenizer_assets_are_temporary(tmp_path, monkeypatch):
    before = str(tmp_path / "before")
    monkeypatch.setenv("FOHO_TPU_ASSETS", before)
    monkeypatch.delenv("FOHO_ALLOW_HASH_TOKENIZER", raising=False)
    with flux_tokenizer_assets() as assets_dir:
        assert os.environ["FOHO_TPU_ASSETS"] == assets_dir
        clip_ids, t5_ids = TI.tokenize_flux_prompt("Remove hands but keep the object.",
                                                   TC.CLIP_L, TT5.T5_XXL)
    # the checkpoint path pads T5 to 512 ids; the hashed fallback gives ~10
    assert clip_ids.shape == (1, 77) and t5_ids.shape == (1, 512)
    assert os.environ["FOHO_TPU_ASSETS"] == before
    assert not os.path.exists(assets_dir)
