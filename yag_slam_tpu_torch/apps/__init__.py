"""User-facing entry points: the ROS-free online mapper (``online``) and the
offline mapping CLI (``offline_mapper``)."""
