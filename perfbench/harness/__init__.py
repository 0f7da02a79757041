"""The benchmark's general machinery: it knows no configuration, traffic mix
or metric by name; those live in files of their own (`perfbench/configs`,
`perfbench/traffic`, `perfbench/metrics`) that `registry` finds."""
