"""Launchers: the serving driver."""
