"""mip-NeRF math and surface shading as plain tensor functions."""
