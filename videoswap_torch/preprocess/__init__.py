"""Preprocessing for the atlas stage: weight-free optical flow."""
