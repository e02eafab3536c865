"""Inference entry point: the Predictor."""
