"""Weights bridge and fixture files of the port."""
