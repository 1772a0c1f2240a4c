"""Utilities of the port that stand in for packages it does not depend on."""
