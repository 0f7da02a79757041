"""Denoiser and audio-encoder modules of the port."""
