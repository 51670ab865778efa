"""The site_loop.run spans of kind "update" (with their warm and capture) over the
engine.sites.update counter, untraced calls, ms: an update site's ADAM step and
tables' rebuild with its filter step."""


def read(run):
    calls = run.untraced()
    secs, sites = run.total("spans", "update_runs_s", calls), run.total("spans", "engine_sites_update", calls)
    return None if secs is None or not sites else 1e3 * secs / sites
