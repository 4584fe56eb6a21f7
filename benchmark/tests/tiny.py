"""Tiny configurations of each configuration file, for the drivers' control
flow on the CPU (every width cut; the published files stay as they are). The
CLIP vocabulary keeps its published size: the synthetic vocabulary's end of
text has its published id."""

TINY = {
    "flux1-kontext-dev": dict(
        transformer={"in_channels": 16, "hidden": 48, "heads": 3, "num_layers": 1,
                     "num_single_layers": 2, "joint_dim": 32, "pooled_dim": 32,
                     "axes_dims_rope": [4, 6, 6], "guidance_embeds": True, "mlp_ratio": 4.0,
                     "dtype": "float32"},
        vae={"latent_channels": 4, "block_out_channels": [8, 16], "layers_per_block": 1,
             "scaling_factor": 0.3611, "shift_factor": 0.1159, "dtype": "float32"},
        clip={"vocab_size": 49408, "hidden_size": 32, "num_layers": 2, "num_heads": 2,
              "intermediate_size": 64, "max_position_embeddings": 77, "layer_norm_eps": 1e-05,
              "eos_token_id": 49407, "dtype": "float32"},
        t5={"vocab_size": 500, "d_model": 32, "d_kv": 8, "d_ff": 64, "num_layers": 2,
            "num_heads": 4, "relative_attention_num_buckets": 32,
            "relative_attention_max_distance": 128, "layer_norm_eps": 1e-06, "dtype": "float32"},
        crop_size=32),
}


def tiny_config(name: str) -> dict:
    return dict(TINY[name])
