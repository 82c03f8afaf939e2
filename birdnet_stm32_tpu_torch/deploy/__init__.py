"""Deployment configuration of the serving drivers (deploy/config.py):
CLI > env > file precedence, JSON or TOML."""
