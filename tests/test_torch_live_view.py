"""isdf_torch's live flight view against isdf_tpu's: the same updates into
both views give the same /scene.json and /state.json, the goal POST (the
3D-Nav-Goal channel) round-trips, the trail and the scene are cut as JAX
cuts them, and close() stops the server thread.  Host-only on both sides:
the JSON must be equal, not close."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from isdf_tpu.viz.live_view import LiveFlightView as JLiveFlightView

from isdf_torch.viz.live_view import LiveFlightView


# straight to 127.0.0.1, whatever proxy the environment names
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _get(url):
    with _OPENER.open(url, timeout=5) as r:
        return r.read()


def _feed(view, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    view.set_scene(points=rng.uniform(0, 8, size=(700, 3)),
                   goal=[7.0, 4.0, 1.0])
    view.set_plan(rng.uniform(0, 8, size=(64, 3)))
    for k in range(30):
        view.update(0.1 * k, rng.uniform(0, 8, size=3),
                    speed=float(rng.uniform()), min_body_sdf=np.float64(0.4),
                    replan_wall_s=1.25, note="tick")


@pytest.mark.parametrize("kw", [dict(), dict(trail_len=10,
                                             max_scene_points=100)])
def test_same_updates_give_the_same_json(kw):
    views = [JLiveFlightView(quiet=True, **kw), LiveFlightView(quiet=True,
                                                              **kw)]
    try:
        for v in views:
            _feed(v)
        for doc in ("scene.json", "state.json"):
            want, got = (json.loads(_get(v.url + doc)) for v in views)
            assert got == want, doc
        state = json.loads(_get(views[1].url + "state.json"))
        assert len(state["trail"]) == kw.get("trail_len", 30)
        assert len(state["plan"]) == 64
        assert set(state["metrics"]) == {"t", "speed", "min_body_sdf",
                                         "replan_wall_s", "note"}
        page = _get(views[1].url).decode()
        assert "isdf_torch live flight" in page and "state.json" in page
    finally:
        for v in views:
            v.close()


def test_trail_truncation_and_downsample():
    """tests/test_live_view.py's case on the port."""
    view = LiveFlightView(quiet=True, trail_len=10, max_scene_points=100)
    try:
        view.set_scene(points=np.zeros((5000, 3)))
        for k in range(50):
            view.update(k * 0.01, [k, 0, 0])
        scene = json.loads(_get(view.url + "scene.json"))
        state = json.loads(_get(view.url + "state.json"))
        assert len(scene["points"]) == 100
        assert len(state["trail"]) == 10
        assert state["trail"][-1][0] == 49.0
        assert state["trail"][0][0] == 40.0
    finally:
        view.close()


def test_goal_post_roundtrip():
    got = []
    view = LiveFlightView(quiet=True, on_goal=lambda g: got.append(g))
    try:
        req = urllib.request.Request(
            view.url + "goal", data=json.dumps([1.5, -2.0, 3.25]).encode(),
            method="POST")
        assert _OPENER.open(req, timeout=5).status == 204
        g = view.poll_goal()
        assert g is not None and np.allclose(g, [1.5, -2.0, 3.25])
        assert view.poll_goal() is None           # cleared after the read
        assert len(got) == 1 and np.allclose(got[0], [1.5, -2.0, 3.25])
        scene = json.loads(_get(view.url + "scene.json"))
        assert scene["goal"] == [1.5, -2.0, 3.25]
        bad = urllib.request.Request(view.url + "goal", data=b"nope",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            _OPENER.open(bad, timeout=5)
        assert e.value.code == 400
        assert _OPENER.open(view.url, timeout=5).status == 200
    finally:
        view.close()


def test_close_stops_the_server_thread():
    view = LiveFlightView(port=0, quiet=True)
    assert view.port > 0 and view._thread.is_alive()
    view.close()
    assert not view._thread.is_alive()
