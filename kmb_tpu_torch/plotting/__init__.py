"""Metrics, Pareto-front extraction, and plot styling (SURVEY.md L5)."""
