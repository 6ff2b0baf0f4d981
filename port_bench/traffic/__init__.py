"""The general generators that read a traffic mix (``port_bench/mixes/
<name>.json``): scenes made on the card from the seed, and the schedule of
an open loop's arrivals."""
