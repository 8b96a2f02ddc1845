"""Torch port: the ERA5 pipeline and its CLI (sbgm_danra_tpu_torch/pipelines/era5,
sbgm_danra_tpu_torch/cli/main_era5_app.py) against the JAX package's.

Each behaviour of ``tests/test_era5.py`` is one case of ``test_same_behaviour``:
the case runs through both packages, fed the same fakes (CDS client, ``cdo`` /
``rsync`` / ``ssh`` runners, netCDF reader), asserts what ``tests/test_era5.py``
asserts, and returns a record of what it saw (requests, dataset names, target
paths, argv, years, resume decisions, ``.npz`` names and arrays, CLI output)
with the temporary root written as ``<tmp>``; the two records must be equal.
The packages' registries (``download.CDS_VARIABLE_NAMES``,
``cdo_utils.DAILY_STAT``) are restored after every case, and loading a config
in one package must leave the other's untouched.
"""

import datetime as dt
import glob
import importlib
import os
import types

import numpy as np
import pytest

PACKAGES = ("sbgm_danra_tpu", "sbgm_danra_tpu_torch")


def _pkg(root: str) -> types.SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.pipelines.era5.{name}")
            for name in ("cdo_utils", "config", "download", "stream", "transfer", "worker")}
    mods["cli"] = importlib.import_module(f"{root}.cli.main_era5_app")
    return types.SimpleNamespace(root=root, **mods)


def _registries(p):
    return dict(p.download.CDS_VARIABLE_NAMES), dict(p.cdo_utils.DAILY_STAT)


@pytest.fixture(autouse=True)
def restore_registries():
    pkgs = [_pkg(root) for root in PACKAGES]
    saved = [_registries(p) for p in pkgs]
    yield
    for p, (names, stats) in zip(pkgs, saved):
        for live, kept in ((p.download.CDS_VARIABLE_NAMES, names),
                           (p.cdo_utils.DAILY_STAT, stats)):
            live.clear()
            live.update(kept)


class FakeClient:
    def __init__(self):
        self.calls = []

    def __call__(self, dataset, request, target):
        self.calls.append((dataset, request, target))
        with open(target, "w") as f:
            f.write("fake-nc")


def _days(year):
    n = 366 if (year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)) else 365
    d = dt.date(year, 1, 1)
    return [(d + dt.timedelta(days=i)).strftime("%Y%m%d") for i in range(n)]


def _fake_reader(year, h=4, w=6):
    def reader(path):
        days = _days(year)
        return days, np.zeros((len(days), h, w), np.float32)

    return reader


def _rel(value, tmp):
    """``value`` with the case's temporary root written as ``<tmp>``."""
    if isinstance(value, str):
        return value.replace(str(tmp), "<tmp>")
    if isinstance(value, dict):
        return {_rel(k, tmp): _rel(v, tmp) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_rel(v, tmp) for v in value)
    if isinstance(value, set):
        return {_rel(v, tmp) for v in value}
    return value


def _npz_tree(root):
    """Every ``.npz`` under ``root``: relative name -> its arrays."""
    out = {}
    for path in sorted(glob.glob(os.path.join(str(root), "**", "*.npz"), recursive=True)):
        with np.load(path) as f:
            out[os.path.relpath(path, root)] = {k: f[k].tolist() for k in f.files}
    return out


def _calls(client):
    return [(d, r, t) for d, r, t in client.calls]


# -- the behaviours of tests/test_era5.py ------------------------------------


def request_payload(p, tmp, capsys):
    req = p.download.build_request("temp", 1995, (60, -80, 40, 40))
    assert req["variable"] == "2m_temperature"
    assert req["year"] == "1995"
    assert len(req["month"]) == 12 and len(req["time"]) == 24
    assert p.download.dataset_name(None) == "reanalysis-era5-single-levels"
    return req, p.download.dataset_name(None)


def pressure_level_request(p, tmp, capsys):
    req = p.download.build_request("z", 2000, (60, -80, 40, 40), pressure_level=500)
    assert req["pressure_level"] == "500"
    assert p.download.dataset_name(500) == "reanalysis-era5-pressure-levels"
    return req, p.download.dataset_name(500)


def unknown_variable(p, tmp, capsys):
    with pytest.raises(ValueError) as e:
        p.download.build_request("bogus", 2000, (60, -80, 40, 40))
    return str(e.value)


def download_skips_existing(p, tmp, capsys):
    client = FakeClient()
    spec = p.download.DownloadSpec(("temp",), (1999,), out_dir=str(tmp))
    p1 = p.download.download_year(client, spec, "temp", 1999)
    p2 = p.download.download_year(client, spec, "temp", 1999)
    assert p1 == p2 and len(client.calls) == 1  # resume: no re-download
    return p1, _calls(client)


def pull_all_fanout(p, tmp, capsys):
    client = FakeClient()
    spec = p.download.DownloadSpec(("temp", "prcp"), (2000, 2001), out_dir=str(tmp),
                                   max_workers=2)
    out = p.download.pull_all(client, spec)
    assert len(out) == 4 and len(client.calls) == 4
    return sorted(out), sorted(_calls(client), key=lambda c: c[2])


def pressure_fanout(p, tmp, capsys):
    client = FakeClient()
    spec = p.download.DownloadSpec(("z",), (2000,), out_dir=str(tmp), pressure_levels=(250, 500))
    out = p.download.pull_all(client, spec)
    assert {os.path.basename(x) for x in out} == {"era5_z_pl250_2000.nc", "era5_z_pl500_2000.nc"}
    return sorted(out), sorted(_calls(client), key=lambda c: c[2]), \
        p.download.target_path(str(tmp), "z", 2000, 250)


def daily_stats_per_variable(p, tmp, capsys):
    stats = [p.cdo_utils.daily_stat_for(v) for v in ("prcp", "cape", "temp")]
    assert stats == ["daysum", "daymax", "daymean"]
    return stats


def command_construction(p, tmp, capsys):
    calls = []
    runner = calls.append
    p.cdo_utils.convert_to_daily_stat("in.nc", "out.nc", "prcp", runner)
    p.cdo_utils.regrid_to_danra("out.nc", "re.nc", "danra.grid", None, runner)
    p.cdo_utils.regrid_to_danra("out.nc", "re.nc", "danra.grid", "w.nc", runner)
    assert calls[0] == ["cdo", "-O", "daysum", "in.nc", "out.nc"]
    assert calls[1] == ["cdo", "-O", "remapbil,danra.grid", "out.nc", "re.nc"]
    assert calls[2][2].startswith("remapbil")  # weights file absent -> inline
    return calls


def find_data_var(p, tmp, capsys):
    found = [p.cdo_utils.find_data_var(["time", "lat", "lon", "t2m"], "temp"),
             p.cdo_utils.find_data_var(["time", "lat", "lon", "weird"], "temp")]
    assert found == ["t2m", "weird"]
    with pytest.raises(ValueError) as e:
        p.cdo_utils.find_data_var(["time", "a", "b"], "temp")
    return found, str(e.value)


def daily_npz_naming(p, tmp, capsys):
    fields = np.arange(48, dtype=np.float32).reshape(2, 4, 6)
    n = p.cdo_utils.convert_daily_to_npz(["20000101", "20000102"], fields, str(tmp), "prcp",
                                         (4, 6))
    assert n == 2
    assert os.path.exists(tmp / "prcp_4x6_20000101.npz")
    return n, _npz_tree(tmp)


def years_to_process_redoes_newest(p, tmp, capsys):
    a = p.stream.years_to_process([1995, 1996, 1997, 1998], {1995, 1996})
    b = p.stream.years_to_process([1995, 1996], set())
    assert a == [1996, 1997, 1998] and b == [1995, 1996]
    return a, b


def download_transfer_delete(p, tmp, capsys):
    client = FakeClient()
    spec = p.download.DownloadSpec(("temp",), (1999, 2000), out_dir=str(tmp))
    argvs, pushed = [], []

    def fake_runner(argv):
        argvs.append(list(argv))
        if argv[0] == "ssh":
            return "era5_temp_1999.nc\n"  # 1999 already remote (will redo: max)
        pushed.append(argv)
        return ""

    done = p.stream.download_transfer_delete(client, spec, "user@cluster", "/scratch/era5",
                                             runner=fake_runner)
    assert done["temp"] == [1999, 2000]
    assert len(pushed) == 2
    assert not list(tmp.glob("*.nc"))  # local files deleted after push
    return done, argvs, _calls(client)


def year_complete_and_partial_cleanup(p, tmp, capsys):
    for d in ("20010101", "20010102"):
        np.savez(os.path.join(str(tmp), f"temp_4x6_{d}.npz"), data=np.zeros((4, 6)))
    complete = p.worker.year_complete(str(tmp), "temp", 2001, (4, 6))
    assert not complete
    assert not list(tmp.glob("*.npz"))  # partial files were cleaned for redo
    return complete


def process_year_and_completeness(p, tmp, capsys):
    raw = tmp / "era5_temp_2001.nc"
    raw.write_text("fake")
    calls = []
    n = p.worker.process_year(str(raw), "temp", 2001, str(tmp / "out"), "danra.grid",
                              _fake_reader(2001, 4, 6), (4, 6), runner=calls.append)
    assert n == 365
    assert p.worker.year_complete(str(tmp / "out"), "temp", 2001, (4, 6))
    assert [c[2].split(",")[0] for c in calls] == ["daymean", "remapbil"]
    return n, calls, sorted(_npz_tree(tmp / "out"))


def run_worker_skips_complete(p, tmp, capsys):
    raw_dir = tmp / "raw"
    raw_dir.mkdir()
    (raw_dir / "era5_temp_2001.nc").write_text("fake")
    (raw_dir / "era5_temp_2002.nc").write_text("fake")
    out_root = str(tmp / "out")

    def reader(path):
        return _fake_reader(2001 if "2001" in path else 2002, 4, 6)(path)

    done1 = p.worker.run_worker(str(raw_dir), out_root, ["temp"], [2001, 2002], "g", reader,
                                (4, 6), runner=lambda argv: None, max_workers=2)
    assert sorted(done1["temp"]) == [2001, 2002]
    done2 = p.worker.run_worker(str(raw_dir), out_root, ["temp"], [2001, 2002], "g", reader,
                                (4, 6), runner=lambda argv: None)
    assert done2["temp"] == []  # everything complete -> nothing processed
    files = _npz_tree(tmp / "out")
    return {k: sorted(v) for k, v in done1.items()}, done2, len(files), files[sorted(files)[0]]


def rsync_command(p, tmp, capsys):
    calls = []
    p.transfer.rsync_push("/data/f.nc", "u@host", "/data", runner=lambda a: calls.append(a) or "")
    assert calls[0][0] == "rsync" and calls[0][-1] == "u@host:/data/"
    return calls


def remote_inventory(p, tmp, capsys):
    listing = "era5_temp_1995.nc era5_temp_1996.nc era5_prcp_1997.nc"
    argvs = []
    years = p.transfer.remote_years_present(
        "u@h", "/d", "temp", runner=lambda a: argvs.append(list(a)) or listing)
    assert years == {1995, 1996}
    return years, argvs


def missing_binary_gate(p, tmp, capsys):
    with pytest.raises(RuntimeError, match="not installed") as e:
        p.cdo_utils.subprocess_runner(["definitely_not_a_real_binary_xyz", "--flag"])
    return str(e.value)


def load_single_level_config(p, tmp, capsys):
    cfg = p.config.load_era5_config("configs/era5_pipeline.yaml")
    assert set(cfg.variables) == {"temp", "prcp", "pev", "cape", "nwvf", "ewvf", "msl"}
    assert cfg.years == (1991, 2020)
    assert len(cfg.year_list) == 30
    assert cfg.pressure_levels == ()
    assert cfg.variables["prcp"].daily_stat == "daysum"
    assert cfg.variables["cape"].daily_stat == "daymax"
    assert cfg.remote is not None and cfg.remote.target.endswith("@cluster.example.org")
    spec = cfg.download_spec()
    assert set(spec.variables) == set(cfg.variables)
    assert spec.area == (60, -80, 40, 40)
    variables = {k: (v.cds_name, v.short, v.daily_stat) for k, v in cfg.variables.items()}
    return (variables, cfg.years, cfg.area, cfg.pressure_levels, cfg.max_workers, cfg.tmp_dir,
            cfg.grid_file, cfg.weights_file, cfg.remote.target, cfg.remote.raw_dir,
            cfg.remote.daily_dir, cfg.remote.npz_dir, spec.variables, spec.years, spec.out_dir)


def load_pressure_config_registers_variables(p, tmp, capsys):
    cfg = p.config.load_era5_config("configs/era5_pressure_pipeline.yaml")
    assert cfg.pressure_levels == (250, 500, 850, 1000)
    req = p.download.build_request("z", 2000, cfg.area, pressure_level=500)
    assert req["variable"] == "geopotential"  # config-declared variables resolve
    assert req["pressure_level"] == "500"
    return cfg.pressure_levels, req


def config_daily_stats_registered(p, tmp, capsys):
    p.config.load_era5_config("configs/era5_pipeline.yaml")
    stats = (p.cdo_utils.daily_stat_for("pev"), p.cdo_utils.daily_stat_for("msl"))
    assert stats == ("daysum", "daymean")
    return stats, _registries(p)


def cli_dry_run(p, tmp, capsys):
    p.cli.main(["--config_path", "configs/era5_pipeline.yaml", "--mode", "download",
                "--dry_run"])
    out = capsys.readouterr().out
    assert "jobs=210" in out  # 7 variables x 30 years
    return out


def cli_dry_run_pressure(p, tmp, capsys):
    p.cli.main(["--config_path", "configs/era5_pressure_pipeline.yaml", "--mode", "download",
                "--dry_run"])
    out = capsys.readouterr().out
    assert "jobs=120" in out  # 1 variable x 30 years x 4 levels
    return out


def cli_download_with_fake_client(p, tmp, capsys):
    fake = FakeClient()
    original = p.download.make_cds_client
    p.download.make_cds_client = lambda: fake
    try:
        cfg_path = tmp / "era5.yaml"
        cfg_path.write_text("variables:\n  2m_temperature: {short: temp, daily_stat: daymean}\n"
                            f"years: [2000, 2001]\ntmp_dir: {tmp}/raw\n")
        p.cli.main(["--config_path", str(cfg_path), "--mode", "download"])
    finally:
        p.download.make_cds_client = original
    assert len(fake.calls) == 2
    assert os.path.exists(tmp / "raw" / "era5_temp_2000.nc")
    return sorted(_calls(fake), key=lambda c: c[2])


def cli_stream_requires_remote(p, tmp, capsys):
    cfg_path = tmp / "era5.yaml"
    cfg_path.write_text("variables: {}\nyears: [2000, 2000]\n")
    with pytest.raises(SystemExit, match="remote") as e:
        p.cli.main(["--config_path", str(cfg_path), "--mode", "stream"])
    return str(e.value)


def stream_honors_pressure_levels_and_var_dirs(p, tmp, capsys):
    fake = FakeClient()
    calls = []

    def runner(argv):
        calls.append(list(argv))
        return ""  # no remote years present

    spec = p.download.DownloadSpec(variables=("z",), years=(2000,), out_dir=str(tmp),
                                   pressure_levels=(250, 500))
    done = p.stream.download_transfer_delete(fake, spec, "u@h", "/scratch/raw/{var}/",
                                             runner=runner)
    assert done["z"] == [2000]
    assert len(fake.calls) == 2  # one CDS request per level
    assert all(c[0] == "reanalysis-era5-pressure-levels" for c in fake.calls)
    assert {c[1]["pressure_level"] for c in fake.calls} == {"250", "500"}
    rsyncs = [c for c in calls if c[0] == "rsync"]  # the rsync target substitutes {var}
    assert rsyncs and all(c[-1] == "u@h:/scratch/raw/z/" for c in rsyncs)
    return done, calls, _calls(fake)


def _pl_reader(path):
    days = _days(2001)
    return days, np.zeros((len(days), 4, 6), np.float32)


def worker_pressure_levels_make_pl_variables(p, tmp, capsys):
    raw = tmp / "raw"
    raw.mkdir()
    for pl in (250, 500):  # level-suffixed raw files as download.target_path writes them
        (raw / f"era5_z_pl{pl}_2001.nc").write_text("fake")
    done = p.worker.run_worker(str(raw), str(tmp / "out"), ["z"], [2001], "grid.txt",
                               _pl_reader, domain_dims=(4, 6), runner=lambda argv: None,
                               pressure_levels=(250, 500))
    assert done["z_pl_250"] == [2001] and done["z_pl_500"] == [2001]
    files = sorted(glob.glob(str(tmp / "out" / "z_pl_500" / "*.npz")))
    assert len(files) == 365
    assert os.path.basename(files[0]).startswith("z_pl_500_4x6_2001")
    return done, [os.path.relpath(f, tmp) for f in files]


def worker_var_dirs_with_pressure_levels(p, tmp, capsys):
    raw_root = tmp / "raw"
    (raw_root / "z").mkdir(parents=True)  # bare-var dir, as stream.py pushes
    for pl in (250, 500):
        (raw_root / "z" / f"era5_z_pl{pl}_2001.nc").write_text("fake")
    done = p.worker.run_worker(str(raw_root / "{var}"), str(tmp / "out" / "{var}"), ["z"],
                               [2001], "grid.txt", _pl_reader, domain_dims=(4, 6),
                               runner=lambda argv: None, pressure_levels=(250, 500))
    assert done["z_pl_250"] == [2001]
    assert done["z_pl_500"] == [2001]
    return done, sorted(_npz_tree(tmp / "out"))


def stream_resume_per_level(p, tmp, capsys):
    fake = FakeClient()
    listing = ("era5_z_pl250_2000.nc era5_z_pl250_2001.nc era5_z_pl500_2000.nc "
               "era5_z_pl500_2001.nc era5_z_pl850_2000.nc")
    calls = []

    def runner(argv):
        calls.append(list(argv))
        return listing if argv[0] == "ssh" else ""

    spec = p.download.DownloadSpec(variables=("z",), years=(2000, 2001), out_dir=str(tmp),
                                   pressure_levels=(250, 500, 850))
    done = p.stream.download_transfer_delete(fake, spec, "u@h", "/scratch/{var}/", runner=runner)
    assert done["z"] == [2001]
    got = {(c[1]["pressure_level"], c[1]["year"]) for c in fake.calls}
    # missing: pl850/2001; suspect redo: pl500/2001 (last pushed of 2001)
    assert got == {("850", "2001"), ("500", "2001")}
    return done, got, calls


def days_in_year(p, tmp, capsys):
    days = [p.worker.days_in_year(y) for y in (1900, 2000, 2001, 2004)]
    assert days == [365, 366, 365, 366]
    return days


CASES = [request_payload, pressure_level_request, unknown_variable, download_skips_existing,
         pull_all_fanout, pressure_fanout, daily_stats_per_variable, command_construction,
         find_data_var, daily_npz_naming, years_to_process_redoes_newest,
         download_transfer_delete, year_complete_and_partial_cleanup,
         process_year_and_completeness, run_worker_skips_complete, rsync_command,
         remote_inventory, missing_binary_gate, load_single_level_config,
         load_pressure_config_registers_variables, config_daily_stats_registered, cli_dry_run,
         cli_dry_run_pressure, cli_download_with_fake_client, cli_stream_requires_remote,
         stream_honors_pressure_levels_and_var_dirs, worker_pressure_levels_make_pl_variables,
         worker_var_dirs_with_pressure_levels, stream_resume_per_level, days_in_year]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_same_behaviour(case, tmp_path, capsys):
    """The case through the JAX package and through the port, each in its own
    temporary directory: the same record."""
    records = []
    for root in PACKAGES:
        tmp = tmp_path / root
        tmp.mkdir()
        records.append(_rel(case(_pkg(root), tmp, capsys), tmp))
    assert records[0] == records[1]


@pytest.mark.parametrize("loaded, other", [(0, 1), (1, 0)], ids=["jax_loads", "port_loads"])
def test_config_leaves_the_other_registries(loaded, other):
    """Loading a config registers its variables and daily statistics in its
    own package only."""
    pkgs = [_pkg(root) for root in PACKAGES]
    before = _registries(pkgs[other])
    pkgs[loaded].config.load_era5_config("configs/era5_pressure_pipeline.yaml")
    pkgs[loaded].config.load_era5_config("configs/era5_pipeline.yaml")
    assert _registries(pkgs[other]) == before
    assert pkgs[loaded].cdo_utils.daily_stat_for("msl") == "daymean"
    assert pkgs[loaded].cdo_utils.DAILY_STAT is not pkgs[other].cdo_utils.DAILY_STAT


def test_port_modules_import_no_yaml_at_module_level():
    """PyYAML is imported inside ``load_era5_config``, not with the module."""
    import ast

    import sbgm_danra_tpu_torch.pipelines.era5.config as cfg_mod

    tree = ast.parse(open(cfg_mod.__file__).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name for n in top for a in n.names} | {getattr(n, "module", None) for n in top}
    assert "yaml" not in names
