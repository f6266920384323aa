"""Reporting: post-training analysis and plots."""
