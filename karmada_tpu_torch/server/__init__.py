"""The port's HTTP serving seam (the port's copy of server/):
`apiserver.ControlPlaneServer` serves a plane's store over HTTP REST +
streaming watch, `remote.RemoteStore` / `remote.RemoteControlPlane` are the
client transports, `metricsserver` the per-daemon /metrics sidecar, and
`scheduler_shim` the scheduler sidecar. The package imports nothing at
load, so `store.watchcache` can import `server.codec` without a cycle."""
