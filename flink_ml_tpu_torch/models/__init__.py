"""Estimators and models of the algorithm library."""
