"""Clustering estimators and models."""
