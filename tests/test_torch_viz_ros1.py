"""The port's viz and ROS1 node.

Viz: one serialized SLAM state loaded by both packages draws the same map
image and trajectory lines through each package's plot_slam (Agg).
ROS1: this box has no ROS, so the node runs headless against stub rospy /
tf2_ros / message modules (tests/test_ros1_node.py's harness, rebuilt on
the port) with the param ``~device`` = "cpu"."""
import sys
import types

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from yag_slam_tpu_torch.core.transform import Transform  # noqa: E402

SEQ_CFG = {"range_threshold": 5.0, "resolution": 0.02, "search_size": 0.5,
           "smear_deviation": 0.05}
LOOP_CFG = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 2.0,
            "smear_deviation": 0.05}


# -- viz ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def state():
    """A 10-scan map of the office world, mapped by the port on the CPU."""
    from yag_slam_tpu_torch.io.simulator import (
        SimWorld, drifted_odometry, simulate_scan, square_loop_trajectory)
    from yag_slam_tpu_torch.matching.matcher import CorrelativeScanMatcher
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam

    gt = square_loop_trajectory(side=5.0, step=0.5, laps=1, start=(-2.5, -2.5))[:10]
    odom = drifted_odometry(gt, yaw_bias=0.0025, seed=1)
    rng = np.random.default_rng(7)
    slam = GraphSlam(CorrelativeScanMatcher(SEQ_CFG, device="cpu", dtype=torch.float64),
                     CorrelativeScanMatcher(LOOP_CFG, loop=True, device="cpu",
                                            dtype=torch.float64))
    for i in range(len(gt)):
        slam.process_scan(simulate_scan(SimWorld.office(), gt[i], n_beams=180,
                                        range_threshold=5.0, noise=0.004, rng=rng,
                                        odom_pose_xyt=odom[i]))
    return slam.serialize()


def _drawn(ax):
    """The image array and extent, and every line's data, of a plot."""
    (im,) = ax.images
    lines = [np.asarray(line.get_xydata()) for line in ax.lines]
    return np.asarray(im.get_array()), list(im.get_extent()), lines


def test_plot_slam_draws_what_jax_draws(state):
    import matplotlib.pyplot as plt

    from yag_slam_tpu.slam.graph_slam import GraphSlam as JaxGraphSlam
    from yag_slam_tpu.utils.viz import plot_slam as jax_plot_slam
    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam
    from yag_slam_tpu_torch.utils import plot_slam

    port = GraphSlam.deserialize(state, device="cpu", dtype=torch.float64)
    jax = JaxGraphSlam.deserialize(state)
    kw = dict(range_threshold=5.0, show_lasers=True)
    got, want = _drawn(plot_slam(port, **kw)), _drawn(jax_plot_slam(jax, **kw))
    plt.close("all")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == pytest.approx(want[1], abs=1e-12)
    assert len(got[2]) == len(want[2]) == len(state["edges"]) + 1 + len(state["scans"])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert {0, 255} <= set(np.unique(got[0]).tolist())


def test_save_slam_figure_and_3d_view(state, tmp_path):
    import matplotlib.pyplot as plt

    from yag_slam_tpu_torch.slam.graph_slam import GraphSlam
    from yag_slam_tpu_torch.utils import save_slam_figure
    from yag_slam_tpu_torch.utils.viz import visualize_slam_3d

    slam = GraphSlam.deserialize(state, device="cpu", dtype=torch.float64)
    path = tmp_path / "map.png"
    assert save_slam_figure(slam, str(path), range_threshold=5.0) == str(path)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and path.stat().st_size > 1000
    ax = visualize_slam_3d(slam, range_threshold=5.0)
    assert ax.name == "3d" and len(ax.lines) >= len(state["scans"])
    plt.close("all")


# -- the ROS1 node, headless ---------------------------------------------------------

class _Obj:
    """Attribute bag for message stubs."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _make_ros_stubs(params, tf_rotation, recorded):
    rospy = types.ModuleType("rospy")
    rospy.init_node = lambda *a, **k: None
    rospy.get_param = lambda name, default=None: params.get(name, default)
    rospy.loginfo = rospy.logwarn = lambda *a, **k: None
    rospy.Duration = lambda s: s

    class _Time:
        @staticmethod
        def now():
            return 123.0

    rospy.Time = _Time

    class Publisher:
        def __init__(self, topic, _type, **kw):
            self.topic = topic

        def publish(self, msg):
            recorded.setdefault("published", []).append((self.topic, msg))

    class Service:
        def __init__(self, name, _type, handler):
            recorded.setdefault("services", {})[name] = handler

    class Subscriber:
        def __init__(self, topic, _type, cb):
            recorded.setdefault("subscribers", {})[topic] = cb

    rospy.Publisher = Publisher
    rospy.Service = Service
    rospy.Subscriber = Subscriber
    rospy.spin = lambda: None

    tf2_ros = types.ModuleType("tf2_ros")

    class Buffer:
        def lookup_transform(self, target, source, stamp, timeout=None):
            recorded.setdefault("tf_lookups", []).append((target, source))
            q = tf_rotation
            return _Obj(transform=_Obj(
                translation=_Obj(x=0.5, y=-0.25, z=0.3),
                rotation=_Obj(x=q[0], y=q[1], z=q[2], w=q[3]),
            ))

    class TransformListener:
        def __init__(self, buf):
            pass

    class TransformBroadcaster:
        def sendTransform(self, t):
            recorded.setdefault("tf_broadcasts", []).append(t)

    tf2_ros.Buffer = Buffer
    tf2_ros.TransformListener = TransformListener
    tf2_ros.TransformBroadcaster = TransformBroadcaster

    geometry = types.ModuleType("geometry_msgs")
    geometry_msg = types.ModuleType("geometry_msgs.msg")

    class Pose:
        def __init__(self):
            self.position = _Obj(x=0.0, y=0.0, z=0.0)
            self.orientation = _Obj(x=0.0, y=0.0, z=0.0, w=1.0)

    class TransformStamped:
        def __init__(self):
            self.header = _Obj(stamp=None, frame_id="")
            self.child_frame_id = ""
            self.transform = _Obj(
                translation=_Obj(x=0.0, y=0.0, z=0.0),
                rotation=_Obj(x=0.0, y=0.0, z=0.0, w=1.0),
            )

    geometry_msg.Pose = Pose
    geometry_msg.TransformStamped = TransformStamped
    geometry.msg = geometry_msg

    nav = types.ModuleType("nav_msgs")
    nav_msg = types.ModuleType("nav_msgs.msg")

    class MapMetaData:
        pass

    class OccupancyGrid:
        def __init__(self):
            self.info = _Obj(resolution=0.0, height=0, width=0, origin=None)
            self.data = []
            self.header = _Obj(frame_id="", stamp=None)

    nav_msg.MapMetaData = MapMetaData
    nav_msg.OccupancyGrid = OccupancyGrid
    nav.msg = nav_msg

    nav_srv = types.ModuleType("nav_msgs.srv")

    class GetMap:
        pass

    class GetMapResponse:
        def __init__(self):
            self.map = None

    nav_srv.GetMap = GetMap
    nav_srv.GetMapResponse = GetMapResponse
    nav.srv = nav_srv

    sensor = types.ModuleType("sensor_msgs")
    sensor_msg = types.ModuleType("sensor_msgs.msg")

    class LaserScan:
        pass

    sensor_msg.LaserScan = LaserScan
    sensor.msg = sensor_msg

    return {
        "rospy": rospy,
        "tf2_ros": tf2_ros,
        "geometry_msgs": geometry,
        "geometry_msgs.msg": geometry_msg,
        "nav_msgs": nav,
        "nav_msgs.msg": nav_msg,
        "nav_msgs.srv": nav_srv,
        "sensor_msgs": sensor,
        "sensor_msgs.msg": sensor_msg,
    }


class _FakeGrid:
    def __init__(self):
        self.resolution = 0.05
        self.width = 4
        self.height = 3
        self.offset = Transform.from_xyt(-1.0, -2.0, 0.0)


class _RecordingMapper:
    """Stands in for ThreadedOnlineMapper: records the glue-layer calls the
    node makes (the SLAM core is covered by tests/test_torch_apps.py)."""

    instances = []

    def __init__(self, **kw):
        self.kw = kw
        self.enqueued = []
        type(self).instances.append(self)

    def enqueue_scan(self, ranges, amin, amax, ainc, rmin, rmax, pose,
                     invert=False):
        self.enqueued.append(dict(ranges=list(ranges), amin=amin, amax=amax,
                                  ainc=ainc, rmin=rmin, rmax=rmax, pose=pose,
                                  invert=invert))

    def map_to_odom(self):
        return Transform.from_xyt(1.5, 2.5, 0.3)

    def render_map(self):
        ros_img = np.array([[0, 100, -1, 0], [0, 0, 0, 100],
                            [-1, -1, 0, 0]], dtype=np.int8)
        return ros_img, _FakeGrid()

    def save_graph(self, path):
        with open(path, "wb") as ff:
            ff.write(b"graph")
        return path


def _run_node(monkeypatch, tf_rotation, params=None, mapper_cls=_RecordingMapper):
    recorded = {}
    params = dict({"~device": "cpu"}, **(params or {}))
    stubs = _make_ros_stubs(params, tf_rotation, recorded)
    for name, mod in stubs.items():
        monkeypatch.setitem(sys.modules, name, mod)

    import yag_slam_tpu_torch.apps.online as online

    mapper_cls.instances.clear()
    monkeypatch.setattr(online, "ThreadedOnlineMapper", mapper_cls)

    from yag_slam_tpu_torch.apps import ros1_node

    ros1_node.main()
    return recorded, mapper_cls.instances[-1]


def _scan_msg(n=8, rng=1.0, step=0.1):
    return _Obj(
        header=_Obj(stamp=11.0, frame_id="base_laser_link"),
        ranges=tuple(rng + step * i for i in range(n)),
        angle_min=-1.0, angle_max=1.0, angle_increment=2.0 / n,
        range_min=0.02, range_max=20.0,
    )


def test_scan_callback_rightside_up(monkeypatch):
    recorded, mapper = _run_node(monkeypatch, tf_rotation=(0, 0, 0, 1))
    cb = recorded["subscribers"]["/scan"]
    cb(_scan_msg())

    assert recorded["tf_lookups"] == [("odom", "base_laser_link")]
    assert len(mapper.enqueued) == 1
    e = mapper.enqueued[0]
    assert e["invert"] is False
    assert e["pose"] == (0.5, -0.25, 0.0)  # yaw 0 from identity quaternion
    assert e["ranges"][0] == 1.0

    # map->odom broadcast fired with the mapper's correction
    t = recorded["tf_broadcasts"][0]
    assert t.header.frame_id == "map" and t.child_frame_id == "odom"
    assert t.transform.translation.x == pytest.approx(1.5)
    assert t.transform.rotation.w != 0.0


def test_scan_callback_upside_down_lidar(monkeypatch):
    # roll = pi: sensor z-axis points down -> ranges must be inverted
    recorded, mapper = _run_node(monkeypatch, tf_rotation=(1, 0, 0, 0))
    recorded["subscribers"]["/scan"](_scan_msg())
    assert mapper.enqueued[0]["invert"] is True


def test_dynamic_map_service_and_value_contract(monkeypatch):
    recorded, mapper = _run_node(monkeypatch, tf_rotation=(0, 0, 0, 1))
    resp = recorded["services"]["dynamic_map"](None)
    msg = resp.map
    assert (msg.info.width, msg.info.height) == (4, 3)
    assert msg.info.resolution == 0.05
    assert msg.info.origin.position.x == pytest.approx(-1.0)
    assert msg.info.origin.position.y == pytest.approx(-2.0)
    assert msg.header.frame_id == "map"
    # ROS occupancy values pass through {-1, 0, 100}
    assert set(msg.data) <= {-1, 0, 100}
    assert len(msg.data) == 12


def test_param_plumbing(monkeypatch):
    params = {"~range_threshold": 7.5, "~min_distance": 0.9,
              "~loop_search_distance": 2.5}
    _, mapper = _run_node(monkeypatch, (0, 0, 0, 1), params)
    kw = mapper.kw
    assert kw["device"] == "cpu"
    assert kw["range_threshold"] == 7.5
    assert kw["seq_config"]["range_threshold"] == 7.5
    assert kw["loop_config"]["range_threshold"] == 7.5
    assert kw["min_distance"] == 0.9
    assert kw["loop_search_distance"] == 2.5


def _real_mapper():
    from yag_slam_tpu_torch.apps.online import ThreadedOnlineMapper

    class Recorded(ThreadedOnlineMapper):
        instances = []

        def __init__(self, **kw):
            super().__init__(**kw)
            type(self).instances.append(self)

    return Recorded


def test_node_drives_the_real_mapper_on_the_cpu(monkeypatch):
    """The node with the port's ThreadedOnlineMapper on ~device = cpu: a
    scan from the callback becomes the graph's first vertex, and
    dynamic_map serves the rendered map in ROS values."""
    recorded, mapper = _run_node(monkeypatch, (0, 0, 0, 1), mapper_cls=_real_mapper())
    try:
        assert mapper.device.type == "cpu"
        # an arc 2 m away: 2 rad in 90 beams, cells next to each other
        recorded["subscribers"]["/scan"](_scan_msg(n=90, rng=2.0, step=0.0))
        assert mapper.drain(timeout=60.0)
        assert len(mapper.slam.graph.vertices) == 1
        msg = recorded["services"]["dynamic_map"](None).map
        assert len(msg.data) == msg.info.width * msg.info.height > 0
        # one observation per cell is below the occupancy grid's pass-through
        # count, so the map is still all unknown
        assert set(msg.data) <= {-1, 0, 100} and msg.info.resolution == 0.05
    finally:
        mapper.close()


def test_node_defaults_to_cuda(monkeypatch):
    """Without ~device the node asks for the card; without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the card-less case")
    stubs = _make_ros_stubs({}, (0, 0, 0, 1), {})
    for name, mod in stubs.items():
        monkeypatch.setitem(sys.modules, name, mod)
    from yag_slam_tpu_torch.apps import ros1_node

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ros1_node.main()
