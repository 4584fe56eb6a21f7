"""Traffic ``inpaint``: stage 3's hand removal on one photo's HOI crops, one
after another, as the stage runs them. Set-up writes the checkpoint
tokenizers' vocabulary files (``frozen.scene.write_flux_tokenizers``) under
the run's scratch directory and points ``FOHO_TPU_ASSETS`` there, builds the
program's FLUX transformer, VAE, CLIP-L and T5-XXL with the benchmark's
weights, draws the crops (``frozen.scene.hoi_crop``) and the initial noise
from the seed, and runs one warm-up crop. A unit is one
``preprocess.inpaint.inpaint_hand(models=...)`` call on the next crop.

The check follows the program from its own state. Of the window's first
unit of each crop it keeps what the towers and the VAE were given and gave
back, and the transformer's latents and velocity at every step (forward
hooks, and the VAE's two methods wrapped on the instance). After the window
the plain reference (``reference/flux.py``), with its own tokens, sigmas,
position ids and packing, compares
- ``token_mismatch``: the ids either tower was given, against its own;
- ``t5_rel``: each T5 block's update, worst block, on the chain the program
  ran: block 0 from the reference's own embedding of its ids, block i+1 from
  the program's output of block i; and the tower's output against the final
  norm of the program's last block. With random weights T5's unscaled
  attention is near an argmax, so a whole-tower gap compounds one rounding's
  flips over 24 blocks (0.35-0.38 for bf16 against 0.94 for the control);
- ``clip_rel``: the CLIP tower's pooled vector on its own ids;
- ``vae_enc_rel``: the crop's latents, encoded from the crop itself;
- ``flux_rel``: the transformer's velocity at the steps drawn from the
  seed, on the program's latents there, the reference's sigma, its packing
  of the program's crop latents, and the program's text states and pooled
  vector (each of which the numbers above check);
- ``update_rel``: the first step's latents against the noise, each step's
  next latents against the Euler step of the program's own velocity, and the
  decoder's input against the last;
- ``vae_dec_rel``: the image decoded from the program's final latents.
"""

from __future__ import annotations

import gc
import os

import numpy as np
import torch

from benchmark.frozen import scene, weights
from benchmark.harness import Check

COUNT_SYNCS = False


PROMPT = "Remove hands but keep the {object}."     # the stage's prompt


def _program_models():
    """(class, its configuration class) of the program's four models, in the
    order of ``reference.flux.MODELS``."""
    from followmyhold_tpu_torch.models import clip_text, flux, t5

    return ((flux.FluxTransformer, flux.FluxConfig), (flux.FluxVae, flux.FluxVaeConfig),
            (clip_text.ClipTextModel, clip_text.ClipTextConfig), (t5.T5Encoder, t5.T5Config))


def _program_config(cls, fields: dict):
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    return cls(**{**fields, "dtype": getattr(torch, fields["dtype"])})


def setup(ctx) -> dict:
    from followmyhold_tpu_torch.ops import attention as pattn
    from followmyhold_tpu_torch.preprocess.inpaint import FluxKontextInpainter

    from benchmark.reference import flux as ref

    dev, config, params = ctx.device, ctx.config, ctx.cell["params"]
    assets = os.path.join(ctx.tmpdir, "assets")
    scene.write_flux_tokenizers(assets)
    os.environ["FOHO_TPU_ASSETS"] = assets
    layouts = ref.layouts(config)
    models = []
    for name, (cls, cfg_cls) in zip(ref.MODELS, _program_models()):
        m = cls(_program_config(cfg_cls, config[name]), device=dev)
        weights.fill(m, layouts[name], ctx.seed, name)
        models.append(m.eval().requires_grad_(False))
    inpainter = FluxKontextInpainter(*models)

    size = config["crop_size"]
    crops = [scene.hoi_crop(size, weights.derived_seed(ctx.seed, "inpaint", f"crop{k}"))
             for k in range(params["crops"])]
    latent = size // 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    n_tokens = (latent // 2) ** 2
    gen = torch.Generator(device=dev).manual_seed(
        weights.derived_seed(ctx.seed, "inpaint", "noise"))
    noise = torch.randn((1, n_tokens, config["transformer"]["in_channels"]), generator=gen,
                        device=dev)
    state = dict(inpainter=inpainter, crops=crops, noise=noise, assets=assets, units=0,
                 rec=None, recs=[], object=params["prompt"]["object"])
    _hooks(ctx, state)
    ctx.probe.span_module(inpainter.transformer, "flux")
    ctx.probe.count_flops(*models)
    ctx.probe.attention(pattn)
    _run(state, 0)                         # the warm-up crop
    return state


def _hooks(ctx, state) -> None:
    inp = state["inpainter"]

    def keep_t5(_m, args, out):
        rec = state["rec"]
        if rec is not None:
            rec["t5_ids"], rec["t5"] = args[0].detach().cpu(), out.detach().clone()

    def keep_block(_m, _args, out):
        rec = state["rec"]
        if rec is not None and rec["crop"] == 0:
            out = out[0] if isinstance(out, tuple) else out
            rec.setdefault("t5_blocks", []).append(out.detach().clone())

    def keep_clip(_m, args, out):
        rec = state["rec"]
        if rec is not None:
            rec["clip_ids"], rec["pooled"] = args[0].detach().cpu(), out[1].detach().clone()

    def keep_step(_m, args, out):
        rec = state["rec"]
        if rec is not None:
            n_img = state["noise"].shape[1]
            rec["steps"].append((args[0][:, :n_img].detach().clone(),
                                 out[:, :n_img].detach().clone()))

    blocks = [m for name, m in inp.t5.named_children() if name.startswith("block")]
    ctx.probe.handles += [m.register_forward_hook(keep_block) for m in blocks]
    ctx.probe.handles += [inp.t5.register_forward_hook(keep_t5),
                          inp.clip.register_forward_hook(keep_clip),
                          inp.transformer.register_forward_hook(keep_step)]
    vae = inp.vae
    encode, decode = vae.encode, vae.decode

    def encode_kept(image):
        out = encode(image)
        if state["rec"] is not None:
            state["rec"]["enc"] = out.detach().clone()
        return out

    def decode_kept(z):
        out = decode(z)
        if state["rec"] is not None:
            state["rec"]["dec_in"], state["rec"]["dec"] = z.detach().clone(), out.detach().clone()
        return out

    vae.encode, vae.decode = encode_kept, decode_kept


def _run(state, k: int) -> np.ndarray:
    from followmyhold_tpu_torch.preprocess.inpaint import inpaint_hand

    img, mask = state["crops"][k % len(state["crops"])]
    return inpaint_hand(img, mask, object_name=state["object"],
                        models=state["inpainter"], initial_noise=state["noise"])


def min_units(ctx) -> int:
    """Every crop runs in every window."""
    return int(ctx.cell["params"]["crops"])


def unit(ctx, state):
    k = state["units"]
    if k < len(state["crops"]):            # the first unit of each crop is kept
        state["rec"] = dict(crop=k, steps=[])
        state["recs"].append(state["rec"])
    out = _run(state, k)
    state["rec"] = None
    state["units"] += 1
    return 1, int(out.shape != state["crops"][0][0].shape)


def step_indices(ctx, n_steps: int) -> list:
    rng = np.random.default_rng(ctx.seed % (2 ** 63))
    picks = rng.choice(n_steps, size=ctx.cell["params"]["flux_checks"], replace=False)
    return sorted(int(i) for i in picks)


def free_program(state) -> None:
    state.pop("inpainter", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _crop(state, dev, k: int) -> torch.Tensor:
    """The crop k as the stage hands it on: [1, H, W, 3] in [-1, 1]."""
    img, _ = state["crops"][k]
    return torch.from_numpy(np.asarray(img, np.float32))[None].to(dev) / 255.0 * 2.0 - 1.0


def reference_outputs(ctx, state, recs: list, control: bool = False) -> dict:
    """The reference's (or the control's) readings on the program's state:
    its token ids, T5 on the program's chain of blocks, the pooled vector,
    and per kept unit the crop's latents, the velocity at the drawn steps and
    the decoded image."""
    from benchmark.reference import flux as ref

    dev, config, seed = ctx.device, ctx.config, ctx.seed
    tc, vc, cc, t5c = (config[k] for k in ref.MODELS)
    clip_ids, t5_ids = ref.tokenize(PROMPT.format(object=state["object"]), state["assets"],
                                    cc["max_position_embeddings"], config["t5_max_length"])
    out = dict(clip_ids=clip_ids, t5_ids=t5_ids, units=[])

    wt = ref.Weights(config, "t5", seed, dev, control)
    chain = recs[0]["t5_blocks"]
    w = wt.group("block0")
    bias = ref.t5_position_bias(w, t5c, t5_ids.shape[1], dev)
    x = ref.t5_embed(wt.group("shared"), torch.from_numpy(t5_ids).to(dev))
    inputs, blocks = [], []
    for i in range(t5c["num_layers"]):
        w = w if i == 0 else wt.group(f"block{i}")
        inputs.append(x)
        blocks.append(ref.t5_block(w, t5c, i, x, bias))
        x = chain[i]                       # the program's output feeds the next block
    out.update(t5_inputs=inputs, t5_blocks=blocks,
               t5_final=ref.t5_final(wt.group("final_norm"), t5c, chain[-1]))
    del w, wt
    out["pooled"] = ref.clip_pooled(ref.Weights(config, "clip", seed, dev, control).all(), cc,
                                    torch.from_numpy(clip_ids).to(dev))

    wv = ref.Weights(config, "vae", seed, dev, control).all()
    calls = []
    for rec in recs:
        steps = step_indices(ctx, len(rec["steps"]))
        out["units"].append(dict(enc=ref.vae_encode(wv, vc, _crop(state, dev, rec["crop"])),
                                 dec=ref.vae_decode(wv, vc, rec["dec_in"]), steps=steps))
        sig = ref.sigmas(len(rec["steps"]), rec["steps"][0][0].shape[1])
        calls += [(rec["steps"][i][0], sig[i], ref.pack(rec["enc"]), rec["t5"], rec["pooled"])
                  for i in steps]
    del wv
    gc.collect()
    h, w_ = recs[0]["enc"].shape[1:3]
    lat, ctx_tokens, t5_states, pooled = (torch.cat([c[k] for c in calls]) for k in (0, 2, 3, 4))
    n = lat.shape[0]
    t = torch.tensor([c[1] for c in calls], dtype=torch.float32, device=dev)
    img_ids, txt_ids = ref.position_ids(h, w_, t5_states.shape[1], dev)
    g = torch.full((n,), float(config["guidance"]), dtype=torch.float32, device=dev)
    v = ref.transformer(ref.Weights(config, "transformer", seed, dev, control), tc,
                        torch.cat([lat.float(), ctx_tokens.float()], dim=1), t5_states, pooled,
                        t, img_ids, txt_ids, g)[:, :lat.shape[1]]
    v = iter(v.split(1))
    for u in out["units"]:
        u["flux"] = {i: next(v) for i in u["steps"]}
    return out


def _update_rel(state, recs: list, step_dtype) -> float:
    """The widest gap of the program's latent chain from the Euler steps of
    its own velocity on the reference's sigmas, worked out in ``step_dtype``
    (bfloat16: the control's reading): the first step's latents against the
    noise, each step's next latents, and the decoder's input."""
    from benchmark.reference import flux as ref

    gap = 0.0
    for rec in recs:
        steps = rec["steps"]
        sig = ref.sigmas(len(steps), steps[0][0].shape[1])
        gap = max(gap, ref.rel(steps[0][0], state["noise"].to(step_dtype).float()))
        for i in range(len(steps)):
            expect = (steps[i][0].to(step_dtype)
                      + float(sig[i + 1] - sig[i]) * steps[i][1].to(step_dtype)).float()
            if i + 1 < len(steps):
                nxt = steps[i + 1][0]
            else:
                h, w = rec["dec_in"].shape[1:3]
                expect, nxt = ref.unpack(expect, h, w), rec["dec_in"]
            gap = max(gap, ref.rel(nxt, expect))
    return gap


def _mismatch(got, want) -> int:
    """Ids that differ (all of them where the lengths differ)."""
    got, want = np.asarray(got), np.asarray(want)
    return int((got != want).sum()) if got.shape == want.shape else max(got.size, want.size)


def compare(ctx, got: dict, want: dict, update_rel: float) -> list:
    """The numbers compared, widest over the kept units, with the cell's
    limits. ``got`` has the layout of ``reference_outputs``' result: the
    program's readings, or the control's."""
    from benchmark.reference import flux as ref

    t5 = max(ref.rel(g - x, w - x) for x, g, w in
             zip(want["t5_inputs"], got["t5_blocks"], want["t5_blocks"]))
    values = dict(
        token_mismatch=float(sum(_mismatch(g, want[k]) for k in ("t5_ids", "clip_ids")
                                 for g in got[k])),
        t5_rel=max([t5] + [ref.rel(g, want["t5_final"]) for g in got["t5_final"]]),
        clip_rel=max(ref.rel(g, want["pooled"]) for g in got["pooled"]),
        vae_enc_rel=max(ref.rel(g["enc"], w["enc"]) for g, w in zip(got["units"], want["units"])),
        flux_rel=max(ref.rel(g["flux"][i], w["flux"][i])
                     for g, w in zip(got["units"], want["units"]) for i in w["flux"]),
        update_rel=update_rel,
        vae_dec_rel=max(ref.rel(g["dec"], w["dec"]) for g, w in zip(got["units"], want["units"])))
    limits = ctx.cell["limits"]
    return [Check(k, float(v), float(limits[k])) for k, v in values.items()]


def program_readings(recs: list) -> dict:
    """The program's readings in ``reference_outputs``' layout, a list over
    the kept units where each unit has its own."""
    return dict(
        t5_ids=[r["t5_ids"] for r in recs], clip_ids=[r["clip_ids"] for r in recs],
        t5_blocks=recs[0]["t5_blocks"], t5_final=[r["t5"] for r in recs],
        pooled=[r["pooled"] for r in recs],
        units=[dict(enc=r["enc"], dec=r["dec"],
                    flux={i: s[1] for i, s in enumerate(r["steps"])}) for r in recs])


def check(ctx, state, control: bool = False):
    """(the checks, and with ``control`` the control's readings of the same
    numbers: the reference in float8 put in the program's place)."""
    recs = state["recs"]
    complete = [r for r in recs if r["steps"] and "dec" in r and "t5" in r and "enc" in r]
    if len(recs) < len(state["crops"]) or len(complete) < len(recs):
        return [Check("units_recorded", float("inf"), 0.0)], None
    free_program(state)
    want = reference_outputs(ctx, state, recs)
    checks = compare(ctx, program_readings(recs), want, _update_rel(state, recs, torch.float32))
    if not control:
        return checks, None
    low = reference_outputs(ctx, state, recs, control=True)
    low.update(t5_ids=[low["t5_ids"]], clip_ids=[low["clip_ids"]],
               t5_final=[low["t5_final"]], pooled=[low["pooled"]])
    values = compare(ctx, low, want, _update_rel(state, recs, torch.bfloat16))
    return checks, {c.name: c.value for c in values}
