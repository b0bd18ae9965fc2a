"""Regression estimators and models."""
