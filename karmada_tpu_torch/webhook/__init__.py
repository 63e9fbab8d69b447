"""Admission framework (see admission.py)."""
