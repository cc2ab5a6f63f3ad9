"""Modules and model families of the port."""
