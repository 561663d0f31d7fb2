"""NerfMLP, the density-gradient chain and the two render models."""


def build_model(hparams: dict, generator=None):
    """Model factory keyed on `nerf.mlp_name`, as the JAX package's
    `models.build_model`: 'mipnerf' -> MipNeRF (1 density channel),
    'panonerf' -> PanoMipNeRF (5, + 3 per head). `generator` seeds the
    weight init."""
    name = hparams["nerf.mlp_name"]
    if name == "mipnerf":
        from pano_nerf_tpu_torch.models.mip_nerf import MipNeRF
        return MipNeRF.from_hparams(hparams, generator)
    if name == "panonerf":
        from pano_nerf_tpu_torch.models.pano_mip_nerf import PanoMipNeRF
        return PanoMipNeRF.from_hparams(hparams, generator)
    raise ValueError(f"Unknown nerf.mlp_name: {name!r}")
