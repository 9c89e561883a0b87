"""Keyframe graph and loop closure: scan context, detection, global solve."""
