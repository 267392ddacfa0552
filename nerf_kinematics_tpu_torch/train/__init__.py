"""Engines and configuration of the port."""
