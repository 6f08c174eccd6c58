"""Jax-free packing of SESYDDataset proposal files and a sequential packed loader."""
