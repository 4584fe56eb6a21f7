from followmyhold_tpu_torch.alignment.mesh_align import align_meshes_impl

__all__ = ["align_meshes_impl"]
