"""Every plotting entry point of the port runs (Agg backend) and draws the
figure maria_tpu draws for the same input: the same axes, and on each
the same count of lines, images and collections. The inputs are carried
across (``convert``) or bit-equal in both packages; private caches."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

from test_torch_map_products import carried, ref_get  # noqa: E402
from test_torch_products import carry  # noqa: E402

CENTER = (150.0, 10.0)


def shape_of(axes) -> list:
    """Per axes: (lines, images, collections, title, xlabel) of a figure,
    an array of axes or one axes."""
    if hasattr(axes, "axes") and isinstance(axes.axes, list):  # a Figure
        axes = axes.axes
    return [(len(ax.get_lines()), len(ax.images), len(ax.collections), ax.get_title(), ax.get_xlabel())
            for ax in np.ravel(axes)]


def same_figure(ours, ref):
    assert shape_of(ours) == shape_of(ref)
    plt.close("all")


@pytest.fixture(scope="module")
def tods(tmp_path_factory):
    """tests/test_plotting.py's TOD (test/1deg, five_second_stare at
    (60, 45) deg, chajnantor, 2-D atmosphere, noise, pW) and the port's
    TOD of its arrays."""
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        plan = maria_tpu.get_plan("five_second_stare", start_time=1.75e9, scan_center=(60.0, 45.0))
        ref = maria_tpu.Simulation(instrument="test/1deg", plans=plan, site="chajnantor", atmosphere="2d",
                                   noise=True, seed=0).run(units="pW")[0]
        yield ref, carry(ref)
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


@pytest.mark.parametrize("kw", [dict(), dict(detrend="slope", n_freq_bins=16), dict(fields=["noise"], max_dets=3)])
def test_tod_plot(tods, kw):
    from maria_tpu.plotting import plot_tod

    ref, ours = tods
    same_figure(ours.plot(**kw), plot_tod(ref, **kw))


def test_twinkle_plot(tods):
    from maria_tpu.plotting import twinkle_plot as ref_twinkle

    from maria_torch.plotting import twinkle_plot

    ref, ours = tods
    anim, ref_anim = twinkle_plot(ours, n_frames=4), ref_twinkle(ref, n_frames=4)
    assert shape_of(anim._fig) == shape_of(ref_anim._fig)
    np.testing.assert_array_equal(anim._fig.axes[0].collections[0].get_offsets(),
                                  ref_anim._fig.axes[0].collections[0].get_offsets())
    plt.close("all")


@pytest.fixture(scope="module")
def maps():
    """A two-channel cluster, the IQUV source, and an IQU source at two
    channels: each package's, bit-equal."""
    ref1, ours1 = ref_get("cluster", center=CENTER, n=48), maria_torch.map.get("cluster", center=CENTER, n=48)
    two = (maria_tpu.map.concatenate([ref1, ref1._replace(nu=[270e9])], dim="nu"),
           maria_torch.map.concatenate([ours1, ours1._replace(nu=[270e9])], dim="nu"))
    pol_ref, pol = ref_get("polarized_source", n=48), maria_torch.map.get("polarized_source", n=48)
    iqu_ref, iqu = pol_ref[0:3], pol[0:3]
    iqu2 = (maria_tpu.map.concatenate([iqu_ref, iqu_ref._replace(nu=[90e9])], dim="nu"),
            maria_torch.map.concatenate([iqu, iqu._replace(nu=[90e9])], dim="nu"))
    return {"two": two, "pol": (pol_ref, pol), "iqu2": iqu2}


@pytest.mark.parametrize("name,kw", [
    ("two", dict()),
    ("two", dict(slices=dict(nu=[0, 1]))),
    ("pol", dict(slices={"stokes": [["I", "Q"], ["U", "V"]]})),
    ("pol", dict(slices="all")),
    ("iqu2", dict(slices="all")),
    ("iqu2", dict(slices=dict(stokes=["I", "Q", "U"], nu=[[0], [1]]), cmap="cmb", contrast=1e-4)),
    ("iqu2", dict(slices=dict(stokes=["Q"], nu=[-1]), center_zero=True, units="uK_RJ")),
    ("two", dict(nu_index=1)),
    ("pol", dict(stokes="U")),
])
def test_projection_map_plot(maps, name, kw):
    """Every ``slices`` form of docs/tutorials.md, and the one-panel form."""
    ref, ours = maps[name]
    same_figure(ours.plot(**kw), ref.plot(**kw))


def test_projection_map_plot_refuses(maps):
    _, ours = maps["iqu2"]
    with pytest.raises(ValueError, match="did you mean 'all'"):
        ours.plot(slices="some")
    with pytest.raises(ValueError, match="no slice dimension"):
        ours.plot(slices={"z": [0]})
    with pytest.raises(ValueError, match="stokes parameter 'V'"):
        ours.plot(slices={"stokes": ["V"]})
    plt.close("all")


@pytest.mark.parametrize("kw", [dict(n_grid=40), dict(n_grid=30, stokes="Q", vmin=-1e-5, vmax=1e-5),
                                dict(slices="all", n_grid=20)])
def test_healpix_map_plot(kw):
    from maria_tpu.map import HEALPixMap as RefHEALPixMap

    from maria_torch.convert import healpix_map_from_arrays

    data = np.random.default_rng(0).standard_normal((3, 1, 1, 12 * 8**2)).astype(np.float32)
    ours, ref = healpix_map_from_arrays(data, "IQU"), RefHEALPixMap(data=data, stokes="IQU")
    if "slices" in kw:
        kw = {"slices": kw["slices"]}
    same_figure(ours.plot(**kw), ref.plot(**kw))


@pytest.mark.parametrize("kw", [dict(), dict(x_unit="arcmin"), dict(slices=dict(nu=[0]), x_unit="deg"),
                                dict(add_beam=False), dict(slices=dict(nu=[1]), add_beam=False, x_unit="arcsec")])
def test_transfer_function_plot(maps, kw, tmp_path):
    ref_in, ours_in = maps["two"]
    rng = np.random.default_rng(0)
    data = np.asarray(ref_in.data) + 1e-6 * rng.standard_normal(ref_in.data.shape)
    ref_out = ref_in._replace(data=data.astype(np.float32))
    ref_out._beam_fwhm = [2e-4, 1e-4]
    ours_out = carried(ref_out)
    ours_out._beam_fwhm = [2e-4, 1e-4]
    tf, ref_tf = ours_out.transfer_function(input_map=ours_in), ref_out.transfer_function(input_map=ref_in)
    same_figure(tf.plot(**kw), ref_tf.plot(**kw))
    path = str(tmp_path / "tf.png")
    tf.plot(filename=path)
    assert (tmp_path / "tf.png").stat().st_size > 0
    plt.close("all")
    with pytest.raises(ValueError, match="curves but"):
        maria_torch.plot_transfer_function(tf.k, tf.T, nu=[1e11])


@pytest.mark.parametrize("frames", [None, ["az/el", "ra/dec", "glon/glat"], "galactic"])
def test_plan_plots(frames):
    """docs/tutorials.md's plan.plot(frames=[...]) and plot_hits on the
    tutorial's back-and-forth plan, cut to 60 s."""
    kw = dict(duration=60, sample_rate=20, start_time="2026-03-05T12:00:00", scan_center=(45, 45),
              scan_pattern="back-and-forth", scan_options={"x_throw": 2, "y_throw": 0, "speed": 1.0}, frame="az/el",
              site="cerro_toco")
    ours, ref = maria_torch.Plan.generate(**kw), maria_tpu.Plan.generate(**kw)
    same_figure(ours.plot(frames=frames), ref.plot(frames=frames))
    ax, ref_ax = ours.plot_hits(x_bins=20, y_bins=30), ref.plot_hits(x_bins=20, y_bins=30)
    np.testing.assert_allclose(ax.collections[0].get_array(), ref_ax.collections[0].get_array(), rtol=0, atol=0)
    same_figure(ax, ref_ax)


def test_ml_mapper_plots(tods):
    """fit(plot=True) plots the map each epoch, and plot_noise_model
    draws each TOD's median PSD and its k modes, as maria_tpu's mapper
    on the same TOD does."""
    from maria_tpu.mappers import MaximumLikelihoodMapper as RefML

    ref_tod, tod = tods
    kw = dict(frame="az/el", width=1.2, resolution=0.05, n_epochs=2, n_cg_iters=2, k=2, units="K_RJ")
    ref, ours = RefML([ref_tod], **kw), maria_torch.MaximumLikelihoodMapper([tod], **kw)
    for mapper in (ref, ours):
        before = len(plt.get_fignums())
        mapper.fit(plot=True, fused=False, plot_kwargs={"slices": "all"})
        assert len(plt.get_fignums()) == before + 2
    for epoch in (-1, 0):
        same_figure(ours.plot_noise_model(epoch=epoch), ref.plot_noise_model(epoch=epoch))
    assert len(ours.plot_noise_model().get_lines()) == 3
    plt.close("all")
    with pytest.raises(RuntimeError, match="fit"):
        maria_torch.MaximumLikelihoodMapper([tod], **kw).plot_noise_model()
