"""NerfMLP, the density-gradient chain and the Pano-NeRF render model."""
