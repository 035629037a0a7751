"""Stereo: census, cost volumes, SGM, WTA, LR check and their CUDA kernels."""
