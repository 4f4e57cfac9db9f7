#!/usr/bin/env python3
"""ROS1 node shim around the port's online mapper.

Counterpart of ``yag_slam_tpu/apps/ros1_node.py``, with the reference
node's features (upstream yag_slam's ros1/slam_node_ros1): subscribes
/scan, publishes latched /map + /map_metadata, serves `yag_slam/save_graph`
and `dynamic_map`, broadcasts map->odom, handles upside-down lidars via the
TF z-axis test, and supports base-map localization bootstrap.  All SLAM
logic lives in yag_slam_tpu_torch.apps.online.ThreadedOnlineMapper; this
file is only ROS I/O glue and imports rospy lazily so the library never
depends on ROS.  The mapper's torch device is the private param
``~device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).

Run:  python -m yag_slam_tpu_torch.apps.ros1_node [--base-map-path MAP.yaml -x X -y Y --th TH]
"""
from __future__ import annotations

import os
import tempfile
import traceback


def main(base_map_path=None, x=0.0, y=0.0, th=0.0):
    import rospy
    import tf2_ros
    from geometry_msgs.msg import Pose, TransformStamped
    from nav_msgs.msg import MapMetaData, OccupancyGrid
    from nav_msgs.srv import GetMap, GetMapResponse
    from sensor_msgs.msg import LaserScan

    from yag_slam_tpu_torch.apps.online import ThreadedOnlineMapper
    from yag_slam_tpu_torch.core.transform import (
        Transform,
        euler_from_quaternion,
    )

    rospy.init_node("yag_slam_tpu", anonymous=False)

    def p(name, default):
        val = rospy.get_param(name, default)
        rospy.loginfo(f"param {name} = {val}")
        return val

    device = p("~device", "cuda")
    odom_frame = p("~odom_frame", "odom")
    map_frame = p("~map_frame", "map")
    sensor_frame = p("~sensor_frame", "base_laser_link")
    map_resolution = p("~map_resolution", 0.05)

    tfb = tf2_ros.Buffer()
    tf2_ros.TransformListener(tfb)
    tbr = tf2_ros.TransformBroadcaster()

    map_pub = rospy.Publisher("/map", OccupancyGrid, queue_size=1, latch=True)
    meta_pub = rospy.Publisher("/map_metadata", MapMetaData, queue_size=1)

    def make_map_msg(ros_img, grid):
        msg = OccupancyGrid()
        msg.info.resolution = grid.resolution
        msg.info.height, msg.info.width = grid.height, grid.width
        msg.data = ros_img.flatten().astype("int8").tolist()
        pose = Pose()
        pose.position.x = grid.offset.x
        pose.position.y = grid.offset.y
        pose.orientation.w = 1.0
        msg.info.origin = pose
        msg.header.frame_id = map_frame
        return msg

    def publish_map(ros_img, grid):
        msg = make_map_msg(ros_img, grid)
        map_pub.publish(msg)
        meta_pub.publish(msg.info)

    base_map = None
    initial_pose = None
    if base_map_path:
        import cv2
        import yaml

        with open(base_map_path) as ff:
            data = yaml.safe_load(ff)
        image_path = os.path.join(os.path.dirname(base_map_path), data["image"])
        im = cv2.imread(image_path)[::-1, :, 0].copy()
        base_map = (im, data["resolution"],
                    [data["origin"][0], data["origin"][1]])
        initial_pose = (x, y, th)

    mapper = ThreadedOnlineMapper(
        device=device,
        seq_config={
            "search_size": p("~sequential_matching_search_size", 0.3),
            "resolution": p("~sequential_matching_resolution", 0.01),
            "smear_deviation": p("~sequential_matching_smear_deviation", 0.07),
            "range_threshold": p("~range_threshold", 20),
        },
        loop_config={
            "search_size": p("~loop_matching_search_size", 4.0),
            "resolution": p("~loop_matching_resolution", 0.05),
            "smear_deviation": p("~loop_matching_smear_deviation", 0.03),
            "range_threshold": p("~range_threshold", 20),
        },
        min_distance=p("~min_distance", 0.5),
        min_rotation=p("~min_rotation", 0.5),
        range_threshold=p("~range_threshold", 20),
        range_threshold_for_map=p("~range_threshold_for_map", 12),
        map_resolution=map_resolution,
        scan_buffer_len=p("~scan_buffer_len", 10),
        loop_search_min_chain_size=p("~loop_search_min_chain_size", 10),
        loop_search_distance=p("~loop_search_distance", 4.0),
        min_response_coarse=p("~min_response_coarse", 0.6),
        min_response_fine=p("~min_response_fine", 0.7),
        base_map=base_map,
        initial_pose=initial_pose,
        map_callback=publish_map,
    )

    def save_graph_srv(req):
        path = getattr(req, "filename", "") or os.path.join(
            tempfile.gettempdir(), "map.graph")
        mapper.save_graph(path)
        rospy.loginfo(f"saved graph at {path}")
        return []

    try:
        from slam_toolbox_msgs.srv import SerializePoseGraph

        rospy.Service("yag_slam/save_graph", SerializePoseGraph, save_graph_srv)
    except ImportError:
        rospy.logwarn("slam_toolbox_msgs unavailable; save_graph service off")

    def dynamic_map_srv(_req):
        resp = GetMapResponse()
        ros_img, grid = mapper.render_map()
        resp.map = make_map_msg(ros_img, grid)
        return resp

    rospy.Service("dynamic_map", GetMap, dynamic_map_srv)

    def broadcast_map_to_odom():
        m2o = mapper.map_to_odom()
        t = TransformStamped()
        t.header.stamp = rospy.Time.now()
        t.header.frame_id = map_frame
        t.child_frame_id = odom_frame
        t.transform.translation.x = m2o.x
        t.transform.translation.y = m2o.y
        (t.transform.rotation.x, t.transform.rotation.y,
         t.transform.rotation.z, t.transform.rotation.w) = m2o.quaternion
        tbr.sendTransform(t)

    def on_scan(msg):
        try:
            tfm = tfb.lookup_transform(
                odom_frame, sensor_frame, msg.header.stamp,
                rospy.Duration(0.1),
            )
        except Exception:
            traceback.print_exc()
            return
        broadcast_map_to_odom()
        tr, ro = tfm.transform.translation, tfm.transform.rotation
        yaw = euler_from_quaternion((ro.x, ro.y, ro.z, ro.w))[2]
        # upside-down lidar: z axis of the sensor frame points down
        up = Transform(tr.x, tr.y, tr.z, ro.x, ro.y, ro.z, ro.w) + Transform(
            0, 0, 100, 0, 0, 0, 1
        )
        mapper.enqueue_scan(
            list(msg.ranges), msg.angle_min, msg.angle_max,
            msg.angle_increment, msg.range_min, msg.range_max,
            (tr.x, tr.y, yaw), invert=up.z < 0,
        )

    rospy.Subscriber("/scan", LaserScan, on_scan)
    rospy.spin()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--base-map-path", default=None)
    ap.add_argument("-x", type=float, default=0.0)
    ap.add_argument("-y", type=float, default=0.0)
    ap.add_argument("--th", type=float, default=0.0)
    a = ap.parse_args()
    main(a.base_map_path, a.x, a.y, a.th)
