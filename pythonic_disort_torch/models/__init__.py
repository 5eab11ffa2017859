"""Solver models of the port."""
