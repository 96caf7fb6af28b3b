"""Tag-map SLAM: bundle adjustment (ba.py), the landmark-sharded BA (dba.py),
the pose graph (posegraph.py) and the mapper that builds BA problems from
detections (map.py). Counterpart of ``isaac_ros_apriltag_tpu/parallel/slam``."""
