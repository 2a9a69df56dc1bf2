"""Planner, skeletons, swap engine and the swapped runtime."""
