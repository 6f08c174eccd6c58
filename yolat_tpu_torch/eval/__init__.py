"""Folded-BN serving engine and the predict core."""
