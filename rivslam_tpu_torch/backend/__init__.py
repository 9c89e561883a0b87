"""The sliding-window SLAM back end."""
